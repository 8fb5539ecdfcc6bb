from repro_torch.models.model import Model, from_jax_params  # noqa: F401
