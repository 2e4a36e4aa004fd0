"""Per-architecture configs of the port; see
:func:`repro_torch.configs.base.get_config`."""
