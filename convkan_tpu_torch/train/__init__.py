"""convkan_tpu_torch.train — see the modules for what each ports."""
