from .frontends import add_config_args, config_from_args, load_config, parse_txt_config
from .schema import TrainConfig, model_config_from
