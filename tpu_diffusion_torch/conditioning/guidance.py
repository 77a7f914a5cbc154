"""Conditioning-mechanism configs (amortized / reconstruction guidance /
replacement).

Counterpart of `tpu_diffusion/conditioning/guidance.py`: frozen dataclasses
with the same fields and defaults. The samplers that dispatch on them are in
`tpu_diffusion_torch.sampling.ancestral`.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Conditioning:
    @classmethod
    def from_configdict(cls, config):
        return cls()


@dataclass(frozen=True)
class Amortized(Conditioning):
    """Condition concatenated as extra input channels; trained with
    condition dropout prob `p_cond`."""

    p_cond: float = 0.9
    n_corrector: int = 0
    delta: float = 0.1

    @classmethod
    def from_configdict(cls, config):
        return cls(p_cond=config["p_cond"],
                   n_corrector=config["n_corrector"], delta=config["delta"])


@dataclass(frozen=True)
class ReconstructionGuidance(Conditioning):
    """Gradient of the likelihood loss through the x0-prediction."""

    gamma: float = 10.0
    start_fraction: float = 1.0
    update_rule: str = "before"
    n_corrector: int = 0
    delta: float = 0.1

    @classmethod
    def from_configdict(cls, config):
        return cls(gamma=config["gamma"],
                   start_fraction=config["start_fraction"],
                   update_rule=config["update_rule"],
                   n_corrector=config["n_corrector"], delta=config["delta"])


@dataclass(frozen=True)
class Replacement(Conditioning):
    """RePaint-style overwrite of observed pixels (optionally noised)."""

    delta: float = 0.1
    start_fraction: float = 1.0
    noise: bool = True
    n_corrector: int = 0

    @classmethod
    def from_configdict(cls, config):
        return cls(delta=config["delta"],
                   start_fraction=config["start_fraction"],
                   noise=config["noise"], n_corrector=config["n_corrector"])


CONDITIONINGS = {
    "amortized": Amortized,
    "reconstruction_guidance": ReconstructionGuidance,
    "replacement": Replacement,
}


def get_conditioning(name: str):
    key = name.lower()
    if key not in CONDITIONINGS:
        raise NotImplementedError(f"Unknown conditioning {name!r}")
    return CONDITIONINGS[key]
