"""Architecture registry: an arch id -> its ArchConfig and its model
(counterpart of `repro.models.registry`)."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig, SHAPES, smoke_config

_ARCH_MODULES = {
    "qwen1.5-4b": "repro_torch.configs.qwen1_5_4b",
    "qwen2.5-32b": "repro_torch.configs.qwen2_5_32b",
    "command-r-plus-104b": "repro_torch.configs.command_r_plus_104b",
    "deepseek-7b": "repro_torch.configs.deepseek_7b",
    "granite-moe-3b-a800m": "repro_torch.configs.granite_moe_3b_a800m",
    "arctic-480b": "repro_torch.configs.arctic_480b",
    "rwkv6-3b": "repro_torch.configs.rwkv6_3b",
    "zamba2-1.2b": "repro_torch.configs.zamba2_1_2b",
    "whisper-medium": "repro_torch.configs.whisper_medium",
    "phi-3-vision-4.2b": "repro_torch.configs.phi_3_vision_4_2b",
}

ARCH_IDS = tuple(_ARCH_MODULES)

def get_config(arch_id: str) -> ArchConfig:
    if arch_id.endswith("-smoke"):
        return smoke_config(get_config(arch_id[: -len("-smoke")]))
    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCH_IDS)}")
    return importlib.import_module(_ARCH_MODULES[arch_id]).CONFIG


def build_model(cfg: ArchConfig, device=None):
    """The model of a config, built on `device` (default: the card; pass
    ``device="cpu"`` for the plain path).  Its parameters are zeros until
    `repro_torch.nn.layers.init_params` draws them (on that device) or
    `load_jax_lm_params` loads a reference tree.  All models share the
    protocol: forward / prefill / init_cache / decode_step."""
    import torch

    from repro_torch.core.graph_tensor import resolve_device
    if cfg.family in ("dense", "moe", "vlm"):
        from repro_torch.nn.transformer import DecoderLM as model
    elif cfg.family == "ssm":
        from repro_torch.models.rwkv import RWKV6LM as model
    elif cfg.family == "hybrid":
        from repro_torch.models.zamba import Zamba2LM as model
    elif cfg.family == "audio":
        from repro_torch.models.whisper import WhisperModel as model
    else:
        raise ValueError(f"unknown family {cfg.family!r}")
    with torch.device(resolve_device(device)):
        return model(cfg)


def runnable_cells() -> list[tuple[str, str]]:
    """All (arch, shape) pairs that are runnable (the reference's rule:
    only sub-quadratic archs take long_500k)."""
    cells = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in SHAPES:
            if cfg.supports_shape(shape):
                cells.append((arch, shape))
    return cells
