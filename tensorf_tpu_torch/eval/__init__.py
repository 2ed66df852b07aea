from .evaluation import RendererHandle, evaluation, evaluation_path, psnrs_calculate
from .metrics import psnr, rgb_lpips, rgb_ssim
