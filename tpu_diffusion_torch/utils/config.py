"""Experiment configuration, in plain Python.

Counterpart of `tpu_diffusion/utils/config.py`: the same
`<dataset>,<likelihood>,<conditioning>` spec strings, fields, defaults,
`PRETRAINED_WEIGHTS` table and dotted CLI overrides, over `ConfigDict`, a
dict whose keys are also attributes (the port needs no `ml_collections`).
"""

from __future__ import annotations


class ConfigDict(dict):
    """Nested config: `c.a.b` reads and writes `c["a"]["b"]`."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name, value):
        self[name] = value

    def to_dict(self) -> dict:
        return {k: v.to_dict() if isinstance(v, ConfigDict) else v
                for k, v in self.items()}


DATASETS = ("mnist", "flowers", "celeba", "cifar10")
LIKELIHOODS = ("inpainting", "outpainting", "hyperresolution", "none")
CONDITIONINGS = ("amortized", "reconstruction_guidance", "replacement",
                 "none")

# Pretrained-weight bootstrap table (reference experiments/config.py:7-35):
# (dataset, conditioning[, likelihood]) -> checkpoint directory to
# warm-start from. Amortized nets depend on the likelihood (the condition
# channels are baked into conv_in); guidance/replacement share one
# unconditional net per dataset. The paths are the JAX package's checkpoint
# run directories; missing entries warm-start nothing, matching the
# reference's empty-model_path fallback (config.py:159-167).
PRETRAINED_WEIGHTS = {
    "mnist": {
        "amortized": {
            "inpainting": "weights/mnist_ddpm_unconditional",
            "outpainting": "weights/mnist_ddpm_unconditional",
        },
        "reconstruction_guidance": "weights/mnist_ddpm_unconditional",
        "replacement": "weights/mnist_ddpm_unconditional",
    },
    "flowers": {
        "amortized": {
            "inpainting": "weights/flowers_inpainting_amortized",
            "outpainting": "weights/flowers_outpainting_amortized",
        },
        "reconstruction_guidance": "weights/flowers_ddpm_unconditional",
        "replacement": "weights/flowers_ddpm_unconditional",
    },
    "celeba": {
        "amortized": {
            "inpainting": "weights/celeba_inpainting_amortized",
            "outpainting": "weights/celeba_outpainting_amortized",
        },
        "reconstruction_guidance": "weights/celeba_ddpm_unconditional",
        "replacement": "weights/celeba_ddpm_unconditional",
    },
}


def pretrained_weights_path(dataset: str, likelihood: str,
                            conditioning: str) -> str:
    """Lookup the warm-start checkpoint path; "" when none is registered
    (reference experiments/config.py:159-167)."""
    entry = PRETRAINED_WEIGHTS.get(dataset, {})
    if conditioning == "amortized":
        return entry.get("amortized", {}).get(likelihood, "")
    val = entry.get(conditioning, "")
    return val if isinstance(val, str) else ""


def _dataset_config(name: str) -> ConfigDict:
    """Dataset geometry (reference config.py:56-72)."""
    c = ConfigDict()
    c.name = name
    if name == "mnist":
        c.image_size, c.num_channels = 28, 1
    elif name == "cifar10":
        c.image_size, c.num_channels = 32, 3
    else:  # flowers / celeba
        c.image_size, c.num_channels = 64, 3
    c.root = "data"
    return c


def _likelihood_config(name: str, dataset: str) -> ConfigDict:
    """Forward-operator defaults (reference config.py:38-54)."""
    c = ConfigDict()
    c.name = name
    if name == "inpainting":
        c.patch_size = 20 if dataset != "mnist" else 14
        c.pad_value = -2.0
    elif name == "outpainting":
        c.patch_size = 24 if dataset != "mnist" else 16
        c.pad_value = -2.0
    elif name == "hyperresolution":
        c.target_height = 16 if dataset != "mnist" else 7
        c.target_width = 16 if dataset != "mnist" else 7
    return c


def _conditioning_config(name: str) -> ConfigDict:
    """Guidance defaults (reference config.py:75-97)."""
    c = ConfigDict()
    c.name = name
    c.n_corrector = 0
    c.delta = 0.1
    if name == "amortized":
        c.p_cond = 0.9
    elif name == "reconstruction_guidance":
        c.gamma = 10.0
        c.start_fraction = 1.0
        c.update_rule = "before"
    elif name == "replacement":
        c.start_fraction = 1.0
        c.noise = True
    return c


def _network_config(dataset: str) -> ConfigDict:
    """Per-dataset UNet configs (reference config.py:100-126)."""
    c = ConfigDict()
    if dataset == "mnist":
        c.num_channels = 32
        c.channel_mult = "1,2,2"
        c.num_res_blocks = 2
        c.num_heads = 4
        c.num_head_channels = -1
        c.attention_resolutions = "14,7"
        c.use_scale_shift_norm = False
    else:
        c.num_channels = 128
        c.channel_mult = ""
        c.num_res_blocks = 2
        c.num_heads = 4
        c.num_head_channels = 64
        c.attention_resolutions = "32,16,8"
        c.use_scale_shift_norm = True
    c.dropout = 0.0
    # "auto": dense attention below 1024 tokens, the flash kernels at/above
    c.attention_impl = "auto"
    # token-axis ring attention over the mesh's "model" axis
    # (parallel/sp.py); pairs with mesh.model_axis > 1
    c.sequence_parallel = False
    c.dtype = "bfloat16"
    return c


def get_config(spec: str = "mnist,inpainting,amortized") -> ConfigDict:
    """Compose a full experiment config from
    "<dataset>,<likelihood>,<conditioning>" (reference config.py:129-193)."""
    parts = spec.split(",")
    if len(parts) != 3:
        raise ValueError(
            f"spec must be <dataset>,<likelihood>,<conditioning>: {spec!r}")
    dataset, likelihood, conditioning = (p.strip() for p in parts)
    if dataset not in DATASETS:
        raise ValueError(f"unknown dataset {dataset!r} (choose {DATASETS})")
    if likelihood not in LIKELIHOODS:
        raise ValueError(
            f"unknown likelihood {likelihood!r} (choose {LIKELIHOODS})")
    if conditioning not in CONDITIONINGS:
        raise ValueError(
            f"unknown conditioning {conditioning!r} (choose {CONDITIONINGS})")

    config = ConfigDict()
    config.spec = spec
    config.dataset = _dataset_config(dataset)
    config.likelihood = _likelihood_config(likelihood, dataset)
    config.conditioning = _conditioning_config(conditioning)
    config.network = _network_config(dataset)
    # warm-start checkpoint ("" = none), from PRETRAINED_WEIGHTS;
    # overridable via --override network.model_path
    config.network.model_path = pretrained_weights_path(
        dataset, likelihood, conditioning)

    # training (reference config.py:172-179)
    config.training = ConfigDict()
    config.training.epochs = 100 if dataset == "flowers" else 10
    config.training.batch_size = 32
    config.training.learning_rate = 1e-3
    config.training.warmup = 1000
    config.training.lr_schedule = "warmup_cosine"
    config.training.grad_clip = 1.0
    config.training.ema_decay = 0.995
    config.training.ema_update_every = 10
    config.training.num_steps = 0  # 0 -> derive from epochs * len(ds)
    config.training.seed = 0

    # diffusion (reference config.py:182-184)
    config.diffusion = ConfigDict()
    config.diffusion.num_steps = 1000

    # testing (reference config.py:186-192)
    config.testing = ConfigDict()
    config.testing.fid = False
    config.testing.fid_features = "random_conv"  # or "inception" w/ weights
    config.testing.lpips = True  # MSE+LPIPS per eval batch (main.py:271,302)
    config.testing.num_test = 96
    config.testing.batch_size = 32
    config.testing.seed = 0
    # refresh the UNet encoder cache every K-th reverse step during
    # amortized conditional sampling (arXiv:2312.09608); 1 is the plain
    # sampler (the reference protocol)
    config.testing.encoder_reuse = 3

    # parallelism: model_axis > 1 shards the UNet's parameters over the
    # mesh's "model" axis (parallel/tp.py) and, with
    # network.sequence_parallel, its attention tokens (parallel/sp.py)
    config.mesh = ConfigDict()
    config.mesh.model_axis = 1

    config.logdir = "logs"
    return config


def apply_overrides(config: ConfigDict, overrides) -> None:
    """Dotted CLI overrides: ["training.batch_size=64", ...]."""
    for item in overrides:
        key, _, val = item.partition("=")
        ref = config
        parts = key.split(".")
        for p in parts[:-1]:
            ref = ref[p]
        old = ref[parts[-1]]
        if isinstance(old, bool):
            ref[parts[-1]] = val.lower() in ("1", "true", "yes")
        elif isinstance(old, int):
            ref[parts[-1]] = int(val)
        elif isinstance(old, float):
            ref[parts[-1]] = float(val)
        else:
            ref[parts[-1]] = val
