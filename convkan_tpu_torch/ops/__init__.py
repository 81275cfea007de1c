"""convkan_tpu_torch.ops — see the modules for what each ports."""
