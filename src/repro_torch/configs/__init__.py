"""Architecture registry (port of ``repro/configs``: every config of the
reference, dense, MoE, SSM, hybrid and encoder-decoder)."""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.configs.base import ArchSpec

ARCH_IDS: List[str] = [
    "chameleon_34b",
    "mistral_nemo_12b",
    "olmo_1b",
    "deepseek_coder_33b",
    "deepseek_67b",
    "mixtral_8x22b",
    "deepseek_moe_16b",
    "falcon_mamba_7b",
    "zamba2_2p7b",
    "seamless_m4t_medium",
    # the paper's own evaluation model
    "tinyllama_1p1b",
]


def get_arch(name: str) -> ArchSpec:
    name = name.replace("-", "_").replace(".", "p")
    if name not in ARCH_IDS:
        raise ValueError(f"unknown arch {name!r}; the port has {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{name}").ARCH
