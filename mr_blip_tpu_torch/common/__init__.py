"""Registry, config (with a YAML reader of its own), run-config validator,
process helpers over ``torch.distributed``, logging, paths and the LR
schedules: the port's counterparts of ``mr_blip_tpu/common/``."""
