"""The sample grids of the CFM CLIs on the CPU: their noise follows
`--seed` (ROADMAP C5) and their Euler chains are graphed.

Each grid's generator is seeded with `train/trainer.py:step_seed(seed,
step)`. The CPU generator reads only the low 32 bits of a seed, so the
former `(seed << 32) + step` drew the same grid noise for every seed. The
tests record the noise each grid draws: two seeds draw different noise,
and one seed draws the same noise twice. The grids' chains replay through
one `GraphCache` of the EMA model, kept across save steps and captured
again after each `set_params`.
"""

import os

import pytest
import torch

from torch_twin import one_torch_thread  # noqa: F401
from tpu_diffusion_torch.cli import train_cifar10, train_conditional_mnist
from tpu_diffusion_torch.sampling.graph import GraphCache

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
GENERATE_SAMPLES = train_cifar10.generate_samples
ODEINT = train_conditional_mnist.odeint


def _cifar_grid_noise(tmp_path, monkeypatch, seed):
    """The noise of each grid of a 2-step run, and the graph caches."""
    seen = []

    def recording(model, generator, n, **kw):
        state = generator.get_state()
        seen.append((torch.randn((n, 32, 32, 3), generator=generator),
                     kw["graphs"]))
        generator.set_state(state)
        return GENERATE_SAMPLES(model, generator, n, **kw)

    monkeypatch.setattr(train_cifar10, "generate_samples", recording)
    train_cifar10.main([
        "--model", "icfm", "--output_dir", str(tmp_path / str(seed)),
        "--num_channel", "16", "--total_steps", "2", "--batch_size", "4",
        "--save_step", "1", "--warmup", "2", "--sample_grid", "2",
        "--sample_steps", "2", "--seed", str(seed), "--device", "cpu",
        "--data_root", os.path.join(FIXTURES, "cifar")])
    return seen


def test_cifar_grid_noise_follows_the_seed(tmp_path, monkeypatch):
    runs = {key: _cifar_grid_noise(tmp_path / key, monkeypatch, seed)
            for key, seed in (("a", 0), ("b", 1), ("a2", 0))}
    for key, seen in runs.items():
        assert len(seen) == 3  # steps 1 and 2, and the final grid
        caches = {id(graphs) for _, graphs in seen}
        graphs = seen[0][1]
        assert len(caches) == 1 and isinstance(graphs, GraphCache)
        # one chain, captured again after each set_params
        assert graphs.captures == 3 and len(graphs.chains) == 1
    for (a, _), (b, _), (a2, _) in zip(runs["a"], runs["b"], runs["a2"]):
        assert not torch.equal(a, b) and torch.equal(a, a2)
    # the grid's noise differs from step to step too
    assert not torch.equal(runs["a"][0][0], runs["a"][1][0])


def _mnist_grid_noise(tmp_path, monkeypatch, seed):
    seen = []

    def recording(v, x0, **kw):
        seen.append((x0.clone(), kw["graphs"], v))
        return ODEINT(v, x0, **kw)

    monkeypatch.setattr(train_conditional_mnist, "odeint", recording)
    train_conditional_mnist.main([
        "--variant", "cfm", "--output_dir", str(tmp_path), "--num_channel",
        "8", "--num_steps", "2", "--batch_size", "16", "--warmup", "1",
        "--sample_steps", "2", "--sample_grid_per_class", "1",
        "--save_every", "1", "--seed", str(seed), "--device", "cpu"])
    return seen


def test_mnist_grid_noise_follows_the_seed(tmp_path, monkeypatch):
    runs = {key: _mnist_grid_noise(tmp_path / key, monkeypatch, seed)
            for key, seed in (("a", 0), ("b", 1), ("a2", 0))}
    for seen in runs.values():
        assert len(seen) == 3  # steps 1 and 2, and the final grid
        graphs, field = seen[0][1:]
        # one cache and one field across the grids: the chain is kept
        # and captured again after each set_params
        assert all(g is graphs and f is field for _, g, f in seen)
        assert graphs.captures == 3 and len(graphs.chains) == 1
    for (a, *_), (b, *_), (a2, *_) in zip(runs["a"], runs["b"],
                                          runs["a2"]):
        assert not torch.equal(a, b) and torch.equal(a, a2)


@pytest.mark.parametrize("step", [0, 1, 5])
def test_grid_seed_is_step_seed(step):
    """The grid generators' seed on the CPU: two base seeds differ in
    their low 32 bits at every step."""
    from tpu_diffusion_torch.train.trainer import step_seed
    a, b = (step_seed(s, step) & 0xFFFFFFFF for s in (0, 1))
    assert a != b
