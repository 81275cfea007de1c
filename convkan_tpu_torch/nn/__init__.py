"""convkan_tpu_torch.nn — see the modules for what each ports."""
