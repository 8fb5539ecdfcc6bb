from repro_torch.configs.base import (  # noqa: F401
    ArchConfig, MeshPlan, MLAConfig, MoEConfig, SSMConfig, ShapeConfig,
    SHAPES, arch_config, get_config, list_archs, register, shape_applicable,
    smoke_config,
)

# import the arch modules so the registry is always populated
from repro_torch.configs import deepseek_moe_16b  # noqa: F401
from repro_torch.configs import granite_8b  # noqa: F401
from repro_torch.configs import granite_20b  # noqa: F401
from repro_torch.configs import grok_1_314b  # noqa: F401
from repro_torch.configs import minicpm3_4b  # noqa: F401
from repro_torch.configs import paper_models  # noqa: F401
from repro_torch.configs import pixtral_12b  # noqa: F401
from repro_torch.configs import rwkv6_7b  # noqa: F401
from repro_torch.configs import starcoder2_15b  # noqa: F401
from repro_torch.configs import whisper_base  # noqa: F401
from repro_torch.configs import zamba2_1_2b  # noqa: F401
