from repro_torch.optim import adamw, compress
