"""convkan_tpu_torch.factory — see the modules for what each ports."""
