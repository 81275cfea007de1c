"""convkan_tpu_torch.basis — see the modules for what each ports."""
