"""ArchSpec: a production config with its reduced smoke twin (port of
``repro/configs/base.py`` without the dry-run shape grid)."""
from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    config: ModelConfig
    smoke: ModelConfig                       # reduced same-family config
    source: str = ""                         # citation tag
