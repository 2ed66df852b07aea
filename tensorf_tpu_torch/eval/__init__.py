from .evaluation import RendererHandle, evaluation, psnrs_calculate
from .metrics import psnr, rgb_lpips, rgb_ssim
