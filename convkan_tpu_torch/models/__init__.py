"""convkan_tpu_torch.models — see the modules for what each ports."""
