"""convkan_tpu_torch.kernels — see the modules for what each ports."""
