from repro_torch.configs.base import (  # noqa: F401
    ArchConfig, MeshPlan, MLAConfig, MoEConfig, SSMConfig, get_config,
    register, smoke_config,
)

# import the ported arch modules so the registry is always populated
from repro_torch.configs import granite_8b  # noqa: F401
from repro_torch.configs import paper_models  # noqa: F401
from repro_torch.configs import rwkv6_7b  # noqa: F401
from repro_torch.configs import zamba2_1_2b  # noqa: F401
