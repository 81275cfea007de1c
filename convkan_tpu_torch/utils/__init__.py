"""convkan_tpu_torch.utils — see the modules for what each ports."""
