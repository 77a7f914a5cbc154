"""`python -m tpu_diffusion_torch.bench`, the twin of the JAX package's
`bench.py`, on the CPU at a tiny width: one JSON line with `bench.py`'s
keys, and the architecture's byte floor equal to `bench.py`'s
`analytic_min_bytes` of the JAX model at the same configuration."""

import json

import jax
import jax.numpy as jnp
import pytest
import torch

from torch_twin import one_torch_thread  # noqa: F401
from tpu_diffusion.models.unet import create_model as jax_create_model
from tpu_diffusion_torch import bench

WIDTH, BATCH = 32, 2
# the keys of the JAX bench's line (bench.py:238-259)
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "batch",
              "ddim_steps", "mfu", "encoder_reuse", "attention_impl",
              "samples_per_sec_k1", "roofline_ratio_hlo", "workload_gflops",
              "program_gflops", "workload_hlo_hbm_gb", "analytic_min_hbm_gb",
              "floor_ms", "hlo_roofline_ms", "measured_ms", "step_time_ms",
              "device"}


@pytest.fixture
def jax_bench():
    """The root `bench.py`, imported with the persistent compilation cache
    it configures undone afterwards."""
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    import bench as jax_bench_module
    for k, v in saved.items():
        jax.config.update(k, v)
    return jax_bench_module


def test_bench_prints_one_line_with_the_bench_keys(capsys):
    line = bench.main(["--device", "cpu", "--num_channels", str(WIDTH),
                       "--batch", str(BATCH), "--steps", "4"])
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and json.loads(out[0]) == json.loads(
        json.dumps(line))
    assert BENCH_KEYS <= set(line)
    assert line["metric"] == "cifar10_ddim100_samples_per_sec_per_chip"
    assert line["value"] > 0 and line["samples_per_sec_k1"] > 0
    assert 0 < line["vs_baseline"] and line["floor_ms"] > 0
    assert line["routes"]["attention_impl"] == ["fused"]
    assert line["routes"]["resblocks_on_kernel"] == [
        "dec_0_0", "dec_0_1", "dec_0_2", "enc_0_0", "enc_0_1"]
    for k in ("k3", "k1"):
        chain = line["chains"][k]
        assert chain["finite"] and chain["in_range"]
        assert len(chain["wall_ms_all"]) == 5
        q = chain["wall_ms"]
        assert q["q1"] <= q["median"] <= q["q3"]
    assert line["chains"]["k3"]["replays_per_chain"] == {"1": 1, "3": 1}
    assert line["chains"]["k1"]["replays_per_chain"] == {"1": 4}


def test_byte_floor_equals_the_jax_bench(jax_bench):
    """forward_cost's bytes, from the port's Conv2d/Linear calls, equal
    bench.py:analytic_min_bytes of the JAX model (bf16 weights, bf16 norms)
    at the same width and batch, exactly."""
    jm = jax_create_model(
        image_size=32, num_channels=WIDTH, num_res_blocks=2, in_channels=3,
        channel_mult=(1, 2, 2, 2), num_heads=4, attention_resolutions="16",
        dropout=0.0, use_scale_shift_norm=True, dtype=jnp.bfloat16,
        norm_dtype=jnp.bfloat16, attention_impl="xla")
    x = jnp.zeros((BATCH, 32, 32, 3), jnp.float32)
    t = jnp.zeros((BATCH,))
    params = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x, t)
    params = jax.tree.map(
        lambda p: jax.ShapeDtypeStruct(p.shape, jnp.bfloat16), params)
    want = jax_bench.analytic_min_bytes(jm, params, x, t)
    model = bench.bench_model(WIDTH, torch.device("cpu"))
    got, flops = bench.forward_cost(model, torch.zeros((BATCH, 32, 32, 3)),
                                    torch.zeros(BATCH))
    assert got == want
    assert flops > 0
