"""Registry mapping --arch ids to ModelConfigs."""
from __future__ import annotations

import importlib

_ARCH_MODULES = {
    "jamba-1.5-large-398b": "repro_torch.configs.jamba_1_5_large_398b",
    "deepseek-7b": "repro_torch.configs.deepseek_7b",
    "command-r-35b": "repro_torch.configs.command_r_35b",
    "qwen3-4b": "repro_torch.configs.qwen3_4b",
    "granite-20b": "repro_torch.configs.granite_20b",
    "dbrx-132b": "repro_torch.configs.dbrx_132b",
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
    "musicgen-large": "repro_torch.configs.musicgen_large",
    "llama-3.2-vision-11b": "repro_torch.configs.llama_3_2_vision_11b",
    "mamba2-1.3b": "repro_torch.configs.mamba2_1_3b",
}

# extra (not part of the assigned pool): e2e training example config
_EXTRA_MODULES = {
    "repro-100m": "repro_torch.configs.repro_100m",
}

ARCH_IDS = tuple(_ARCH_MODULES)                 # the assigned pool
ALL_IDS = ARCH_IDS + tuple(_EXTRA_MODULES)
_ARCH_MODULES = {**_ARCH_MODULES, **_EXTRA_MODULES}


def get_config(arch_id: str):
    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[arch_id]).CONFIG


def all_configs():
    return {a: get_config(a) for a in ARCH_IDS}
