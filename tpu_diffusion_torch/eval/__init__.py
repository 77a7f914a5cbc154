from tpu_diffusion_torch.eval.metrics import eval_statistics, mse, psnr, ssim

__all__ = ["eval_statistics", "mse", "psnr", "ssim"]
