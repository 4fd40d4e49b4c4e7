"""Typed configuration tree with YAML + CLI override.

The reference merges a flat YAML dict with argparse flags, argparse winning
(step_recognition/main.py:27-30), and uses fire.Fire for the anticipation
drivers (llama_meta.py:394-395). Here there is one dataclass per subsystem,
all YAML keys keep the reference's exact names (they surface in output
paths/artifacts), and CLI overrides use ``--key value`` / ``--key`` for
booleans, applied after YAML.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


def _coerce(value: str, to_type: Any) -> Any:
    if to_type is bool:
        if isinstance(value, bool):
            return value
        return str(value).lower() in ("1", "true", "yes", "on")
    if to_type is int:
        return int(value)
    if to_type is float:
        return float(value)
    return value


@dataclass
class RecognitionConfig:
    """Step-recognition (MiniROAD) config.

    Field names match the reference YAML keys
    (step_recognition/configs/miniroad_assembly101-O.yaml) so configs are
    drop-in compatible.
    """

    model: str = "MiniROAD"
    data_name: str = "ASSEMBLY101-O"
    task: str = "OAD"
    loss: str = "NONUNIFORM"
    metric: str = "AP"
    optimizer: str = "AdamW"
    device: str = "cuda"
    feature_pretrained: str = "kinetics"
    root_path: str = "Assembly101-O"
    rgb_type: str = "rgb_anet_resnet50"
    flow_type: str = "flow_anet_resnet50"
    annotation_type: str = "target_perframe"
    video_list_path: str = "data_info/video_list.json"
    output_path: str = "checkpoints"
    window_size: int = 128
    batch_size: int = 16
    test_batch_size: int = 1
    num_epoch: int = 10
    lr: float = 1e-4
    weight_decay: float = 0.05
    num_workers: int = 4
    dropout: float = 0.2
    num_classes: int = 86
    embedding_dim: int = 2048
    hidden_dim: int = 1024
    num_layers: int = 1
    stride: int = 4
    anticipation_length: int = 0  # only used by the MiniROADA variant
    actionness: bool = False

    # Runtime knobs (new; no reference equivalent)
    eval: Optional[str] = None  # checkpoint path -> eval-only mode
    amp: bool = False  # bf16 compute for the train step
    lr_scheduler: bool = False
    tensorboard: bool = False
    no_rgb: bool = False
    no_flow: bool = False
    seed: int = 20
    eval_output_dir: str = "output_miniRoad"  # reference hardcodes this dir
    eval_output_name: str = "output_miniROAD.json"

    extras: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_yaml(
        cls, path: str, overrides: Optional[List[str]] = None
    ) -> "RecognitionConfig":
        import yaml  # only the YAML loader needs pyyaml

        with open(path) as f:
            raw = yaml.safe_load(f) or {}
        return cls.from_dict(raw, overrides)

    @classmethod
    def from_dict(
        cls, raw: Dict[str, Any], overrides: Optional[List[str]] = None
    ) -> "RecognitionConfig":
        raw = dict(raw)
        if overrides:
            raw.update(parse_overrides(overrides))
        names = {f.name: f for f in dataclasses.fields(cls)}
        kwargs: Dict[str, Any] = {}
        extras: Dict[str, Any] = {}
        for k, v in raw.items():
            if k in names and k != "extras":
                kwargs[k] = _coerce(v, names[k].type if isinstance(names[k].type, type) else type(names[k].default))
            else:
                extras[k] = v
        cfg = cls(**kwargs)
        cfg.extras = extras
        return cfg

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d.update(d.pop("extras"))
        return d

    def __getitem__(self, key: str) -> Any:
        # Reference code accesses cfg as a flat dict; keep that surface.
        if hasattr(self, key):
            return getattr(self, key)
        return self.extras[key]

    def get(self, key: str, default: Any = None) -> Any:
        try:
            return self[key]
        except KeyError:
            return default


def parse_overrides(argv: List[str]) -> Dict[str, Any]:
    """Parse ``--key value`` / ``--key=value`` / bare ``--flag`` pairs."""
    out: Dict[str, Any] = {}
    i = 0
    while i < len(argv):
        tok = argv[i]
        if not tok.startswith("--"):
            raise ValueError(f"expected --key, got {tok!r}")
        key = tok[2:]
        if "=" in key:
            key, val = key.split("=", 1)
            out[key] = _parse_scalar(val)
            i += 1
        elif i + 1 < len(argv) and not argv[i + 1].startswith("--"):
            out[key] = _parse_scalar(argv[i + 1])
            i += 2
        else:
            out[key] = True
            i += 1
    return out


def _parse_scalar(s: str) -> Any:
    """YAML-style scalar: bool, null, int, float, else the string itself
    (without pyyaml, so CLI overrides work where it is not installed)."""
    low = s.strip().lower()
    if low in ("true", "yes", "on"):
        return True
    if low in ("false", "no", "off"):
        return False
    if low in ("null", "~", ""):
        return None
    for cast in (int, float):
        try:
            return cast(s)
        except ValueError:
            pass
    if len(s) >= 2 and s[0] == s[-1] and s[0] in "'\"":
        return s[1:-1]
    return s
