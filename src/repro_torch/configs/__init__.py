"""Per-architecture configs of the ported LM serving path; see
:func:`repro_torch.configs.base.get_config`."""
