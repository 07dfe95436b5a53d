# Model configurations: a copy of repro/configs (base + one module per
# architecture).
