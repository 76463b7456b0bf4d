"""Config system: one dataclass and presets for the ported benchmark configs.

The field names are those of ``bsls_tpu/utils/config.py`` so that a config
file written for the JAX package (``configs/*.json``) loads here too.  Fields
of parts that are not ported yet are accepted only at their "off" value;
anything else raises ``NotImplementedError`` — nothing is silently dropped.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional

__all__ = ["RunConfig", "PRESETS", "load_config"]

# fields of the reference's RunConfig whose feature is not ported yet, with
# the value that means "off" and the slice that brings the feature
_UNPORTED_OFF = {
    "unroll": (1, "no scan to unroll: the port's chunk is a Python loop"),
}


@dataclass
class RunConfig:
    # instance
    config: str = "tiny"  # tiny | medium | traffic | large | <path.npz|path.mat>
    seed: int = 0
    instance_kwargs: dict = field(default_factory=dict)
    scenarios: int = 1  # > 1 batches the instance to S right-hand sides
    # solver
    method: str = "pgd"  # pgd | apgd | lbfgs | eg | frank_wolfe | afw
    line_search: str = "exact"  # exact | bb | bbm | fixed | pava
    tol: float = 1e-6
    max_iter: int = 10_000
    chunk: int = 100
    step_size: float = 0.0
    refine: int = 0  # post-solve f64-anchored polish rounds (solve(refine=K))
    refine_tol: Optional[float] = None  # certified adaptive refine target
    dtype: str = "float32"
    equilibrate: bool = True
    layout: str = "auto"  # auto | banded | gather  (ops.layout.prepare)
    # mesh (parallel.make_mesh): 0 = no mesh; block x scenario must equal the
    # world size (torchrun's, or a world of one)
    mesh_block: int = 0
    mesh_scenario: int = 1
    # harness
    device: str = "cuda"  # cuda | cpu
    oracle: bool = False  # compute CPU float64 oracle for parity metrics
    profile_dir: Optional[str] = None  # torch.profiler trace of the solve
    checkpoint_path: Optional[str] = None
    checkpoint_every: int = 0  # chunks (eq: outer iterations) between checkpoints (0 = off)
    resume: bool = False
    metrics_path: Optional[str] = None  # JSONL metrics output

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_dict(d: dict) -> "RunConfig":
        d = dict(d)
        for key, (off, what) in _UNPORTED_OFF.items():
            if key in d and d.pop(key) != off:
                raise NotImplementedError(
                    f"config field {key!r} is not ported yet ({what})")
        return RunConfig(**d)


PRESETS = {
    "tiny": RunConfig(config="tiny", method="pgd", line_search="exact"),
    "medium-pgd": RunConfig(config="medium", method="pgd"),
    "medium-pgd-x128": RunConfig(config="medium", method="pgd", scenarios=128),
    "medium-eg": RunConfig(config="medium", method="eg"),
    "medium-lbfgs": RunConfig(config="medium", method="lbfgs"),
    # corridor-structured instance: prepare(layout="auto") picks the
    # banded-split layout
    "medium-banded": RunConfig(config="medium_banded", method="pgd", line_search="bbm"),
    # the grid-network route-flow instance with equality constraints
    # (configs/traffic.json): lbfgs inners of the augmented-Lagrangian loop
    "traffic": RunConfig(config="traffic", method="lbfgs"),
    # config 4: 1M uniform blocks x 4 scenarios (run it on a mesh with
    # --mesh-block/--mesh-scenario, or on one device)
    "large": RunConfig(
        config="large", method="pgd",
        instance_kwargs={"num_blocks": 1_000_000, "dim": 8, "num_scenarios": 4},
        mesh_block=0, chunk=50,
    ),
    "sweep-fw": RunConfig(config="medium", method="frank_wolfe"),
    "sweep-eg": RunConfig(config="medium", method="eg"),
    "sweep-pgd-pava": RunConfig(config="medium", method="pgd", line_search="pava"),
}


def load_config(name_or_path: str, **overrides) -> RunConfig:
    if name_or_path in PRESETS:
        cfg = dataclasses.replace(PRESETS[name_or_path])
    elif name_or_path.endswith(".json"):
        with open(name_or_path) as f:
            cfg = RunConfig.from_dict(json.load(f))
    else:
        cfg = RunConfig(config=name_or_path)
    for k, v in overrides.items():
        if v is not None:
            setattr(cfg, k, v)
    return cfg
