from .losses import LossWeights, mse_loss, occlusion_loss
from .optim import TwoGroupAdam, make_optimizer
from .sampler import SimpleSampler
from .step import TrainStatics, loss_fn, make_train_step
