"""The protein evaluation stack of the port against the JAX package.

`protein/mpnn.py` (features, encode, decode, the forward, the decode loop
with the JAX order and Gumbel draws handed in, the public state dict and
the flat npz through both loaders), `protein/self_consistency.py` with
`StubScorer` (and a fake ColabFold), `protein/evaluate.py` (each stage,
`eval_many`'s process pool, `main`), and `protein/novelty.py` over the
port's copy of `native/novelty.cpp`, against the JAX package's build and
the numpy plain version. The MPNN runs at the JAX tests' size (hidden 32,
k 6) in fp32 on the CPU, on random-walk chains with 3.8 A steps (like
tests/test_eval_many.py's). Each residue's two bonded neighbours sit at
one distance to within rounding, so which of them comes first in a row of
the k-NN graph depends on how the squared distance was rounded (eager JAX
and the port agree; jitted XLA may not): per-neighbour tensors are
compared with each row's slots in neighbour order, the K neighbours as
sets.
"""

import json
import os
import stat
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_twin import one_torch_thread  # noqa: F401
from tpu_diffusion.protein import evaluate as jax_evaluate
from tpu_diffusion.protein import mpnn as jax_mpnn
from tpu_diffusion.protein import novelty as jax_novelty
from tpu_diffusion.protein import self_consistency as jax_sc
from tpu_diffusion_torch.convert import mpnn_state_dict_from_flax
from tpu_diffusion_torch.protein import evaluate, mpnn, novelty
from tpu_diffusion_torch.protein import self_consistency as sc

HIDDEN, K, L = 32, 6, 20
TOL = 1e-5       # fp32 on both sides; only the order of the sums differs
PUBLISHED_PARAMS = 1627717   # hidden 128, k 48, 3 + 3 layers


def chain(n, seed=0):
    rng = np.random.default_rng(seed)
    steps = rng.normal(0, 1, (n, 3))
    steps = 3.8 * steps / np.linalg.norm(steps, axis=-1, keepdims=True)
    return np.cumsum(steps, 0)


def chains(n, seed=0, base=40):
    return {f"s{i}": chain(base + 4 * i, seed + i) for i in range(n)}


def random_flax_params(jax_model, seed=0):
    """A flax tree for `jax_model` drawn with numpy: nonzero biases and
    norm offsets, so every parameter shows in the outputs."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0),
                            jnp.zeros((8, 3)), jnp.zeros(8, jnp.int32),
                            jnp.arange(8), jnp.ones(8))

    def draw(path, sd):
        leaf = path[-1].key
        if leaf == "kernel":
            v = rng.standard_normal(sd.shape) / np.sqrt(sd.shape[0])
        elif leaf == "scale":
            v = 1 + 0.1 * rng.standard_normal(sd.shape)
        elif leaf == "embedding":
            v = rng.standard_normal(sd.shape) / np.sqrt(sd.shape[1])
        else:
            v = 0.1 * rng.standard_normal(sd.shape)
        return jnp.asarray(v.astype(np.float32))

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def twins():
    jm = jax_mpnn.CAProteinMPNN(hidden=HIDDEN, k=K)
    params = random_flax_params(jm)
    port = mpnn.CAProteinMPNN(hidden=HIDDEN, k=K, device="cpu")
    mpnn.load_mpnn_state_dict(port, mpnn_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    return jm, params, port.eval()


def inputs(n=L, seed=0, pad=0):
    rng = np.random.default_rng(seed + 100)
    coords = chain(n, seed).astype(np.float32)
    mask = np.ones(n, np.float32)
    if pad:
        coords[-pad:] = 7.0
        mask[-pad:] = 0.0
    tokens = rng.integers(0, 21, n).astype(np.int32)
    order = rng.permutation(n).astype(np.int32)
    return coords, mask, tokens, order


def t(x, dtype=None):
    x = torch.from_numpy(np.array(x))
    return x.to(dtype) if dtype else x


def by_neighbour(e_idx, *per_slot):
    """Each row's slots in ascending neighbour index: the row's neighbour
    set, then each [L, K, ...] tensor in that order."""
    e_idx = np.asarray(e_idx)
    perm = np.argsort(e_idx, axis=1)
    rows = np.arange(len(e_idx))[:, None]
    return [e_idx[rows, perm]] + [np.asarray(x)[rows, perm]
                                  for x in per_slot]


def close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=tol, rtol=0)


# --- the model ---------------------------------------------------------


@pytest.mark.parametrize("pad", [0, 4])
def test_features_match_jax(twins, pad):
    jm, params, port = twins
    coords, mask, _, _ = inputs(pad=pad)
    h_e, e_idx, mask_attend = jax.jit(lambda c, k: jm.apply(
        params, c, k, method=lambda m, c, k: m._features(c, k)))(coords,
                                                                  mask)
    with torch.no_grad():
        ph_e, pe_idx, pmask = port._features(t(coords), t(mask))
    got = by_neighbour(pe_idx.numpy(), pmask.numpy(), ph_e.numpy())
    want = by_neighbour(e_idx, mask_attend, h_e)
    np.testing.assert_array_equal(got[0], want[0])
    close(got[1], want[1], 0)
    close(got[2], want[2])


@pytest.mark.parametrize("pad", [0, 4])
def test_encode_decode_forward_match_jax(twins, pad):
    jm, params, port = twins
    coords, mask, tokens, order = inputs(seed=1, pad=pad)
    if pad:  # padded positions decode last, as the JAX padding test does
        order = np.concatenate([order[order < L - pad],
                                np.arange(L - pad, L, dtype=np.int32)])
    enc = jax.jit(lambda c, k: jm.apply(
        params, c, k, method=jax_mpnn.CAProteinMPNN.encode))(coords, mask)
    want = jax.jit(jm.apply)(params, coords, tokens, order, mask)
    with torch.no_grad():
        penc = port.encode(t(coords), t(mask))
        got = port(t(coords), t(tokens, torch.long), t(order, torch.long),
                   t(mask))
        dec = port.decode(*(t(np.asarray(a)) for a in enc[:2]),
                          t(np.asarray(enc[2]), torch.long), t(mask),
                          t(np.asarray(enc[3])), t(tokens, torch.long),
                          t(order, torch.long))
    close(penc[0], enc[0])
    for a, b in zip(by_neighbour(penc[2].numpy(), penc[1].numpy(),
                                 penc[3].numpy()),
                    by_neighbour(enc[2], enc[1], enc[3])):
        close(a, b)
    close(got, want)
    # decode alone, from the JAX encoder's outputs
    close(dec, want)


def jax_decode_loop(jm, params, coords, mask, order, init, fixed, key,
                    temperature):
    """The JAX decode chain as `make_mpnn_fns.sample` runs it, one jitted
    decode pass per step, and each step's Gumbel draw."""
    enc = jm.apply(params, coords, mask, method=jax_mpnn.CAProteinMPNN.encode)
    decode = jax.jit(lambda tok, o: jm.apply(
        params, *enc[:2], enc[2], mask, enc[3], tok, o,
        method=jax_mpnn.CAProteinMPNN.decode))
    tokens = jnp.asarray(init)
    noise = []
    for step in range(len(order)):
        lp = decode(tokens, jnp.asarray(order))
        p = int(order[step])
        key, k = jax.random.split(key)
        noise.append(np.asarray(jax.random.gumbel(k, (lp.shape[-1],))))
        tok = jax.random.categorical(k, lp[p] / temperature)
        tok = jnp.where(fixed[p] > 0, tokens[p], tok)
        tokens = tokens.at[p].set(tok)
    return np.asarray(tokens), np.stack(noise)


@pytest.mark.parametrize("motif", [False, True])
def test_decode_loop_replays_jax(twins, motif):
    """Same order and Gumbel draws -> the same tokens, step for step, with
    fixed positions keeping theirs."""
    jm, params, port = twins
    coords, mask, _, order = inputs(seed=2)
    init = np.zeros(L, np.int32)
    fixed = np.zeros(L, np.float32)
    if motif:
        idx = [2, 5, 9]
        init[idx] = [18, 6, 19]
        fixed[idx] = 1.0
        order = np.concatenate([order[np.isin(order, idx)],
                                order[~np.isin(order, idx)]])
    key = jax.random.PRNGKey(3)
    want, noise = jax_decode_loop(jm, params, coords, mask, order, init,
                                  fixed, key, 0.1)
    _, sample = mpnn.make_mpnn_fns(port)
    got = sample(t(coords), order, t(mask), t(init), t(fixed), 0.1,
                 noise=t(noise))
    np.testing.assert_array_equal(got.numpy(), want)
    if motif:
        np.testing.assert_array_equal(got.numpy()[[2, 5, 9]], [18, 6, 19])
    else:  # the JAX package's own scan, from the same key
        _, jax_sample = jax_mpnn.make_mpnn_fns(jm, params)
        scan = jax_sample(coords, order, key, mask, init, fixed,
                          temperature=0.1)
        np.testing.assert_array_equal(np.asarray(scan), want)


def test_gumbel_draws_without_noise(twins):
    """Without `noise` the draws come from the generator: one seed, one
    sequence; the rows are standard Gumbel."""
    _, _, port = twins
    coords, mask, _, order = inputs(seed=4)
    _, sample = mpnn.make_mpnn_fns(port)
    args = (t(coords), order, t(mask), torch.zeros(L, dtype=torch.long),
            torch.zeros(L))
    a = sample(*args, generator=torch.Generator().manual_seed(5))
    b = sample(*args, generator=torch.Generator().manual_seed(5))
    assert torch.equal(a, b)
    g = mpnn.gumbel_noise((20000,), torch.Generator().manual_seed(0), "cpu")
    assert abs(g.mean().item() - 0.5772) < 0.03      # Euler-Mascheroni
    assert abs(g.var().item() - np.pi ** 2 / 6) < 0.1


def _synthetic_state_dict(hidden=32, vocab=21):
    """The released checkpoint layout (ca_model_weights/*.pt keys) at tiny
    dims, as tests/test_mpnn.py builds it: every Linear as [out, in] +
    bias, LayerNorms, the embedding."""
    rng = np.random.default_rng(0)
    sd = {}

    def lin(name, din, dout, bias=True):
        sd[f"{name}.weight"] = rng.normal(0, 0.05, (dout, din))
        if bias:
            sd[f"{name}.bias"] = rng.normal(0, 0.05, (dout,))

    def ln(name, d):
        sd[f"{name}.weight"] = np.ones(d)
        sd[f"{name}.bias"] = np.zeros(d)

    lin("features.embeddings.linear", 66, 16)
    lin("features.edge_embedding", 16 + 9 * 16, hidden, bias=False)
    ln("features.norm_edges", hidden)
    lin("W_e", hidden, hidden)
    sd["W_s.weight"] = rng.normal(0, 0.05, (vocab, hidden))
    for i in range(3):
        for w, din in (("W1", 3 * hidden), ("W2", hidden), ("W3", hidden),
                       ("W11", 3 * hidden), ("W12", hidden),
                       ("W13", hidden)):
            lin(f"encoder_layers.{i}.{w}", din, hidden)
        for n in ("norm1", "norm2", "norm3"):
            ln(f"encoder_layers.{i}.{n}", hidden)
        lin(f"encoder_layers.{i}.dense.W_in", hidden, 4 * hidden)
        lin(f"encoder_layers.{i}.dense.W_out", 4 * hidden, hidden)
        for w, din in (("W1", 4 * hidden), ("W2", hidden), ("W3", hidden)):
            lin(f"decoder_layers.{i}.{w}", din, hidden)
        for n in ("norm1", "norm2"):
            ln(f"decoder_layers.{i}.{n}", hidden)
        lin(f"decoder_layers.{i}.dense.W_in", hidden, 4 * hidden)
        lin(f"decoder_layers.{i}.dense.W_out", 4 * hidden, hidden)
    lin("W_out", hidden, vocab)
    return sd


def test_public_state_dict_loads_into_both():
    sd = _synthetic_state_dict(HIDDEN)
    jm = jax_mpnn.CAProteinMPNN(hidden=HIDDEN, k=K)
    params = jax_mpnn.convert_mpnn_state_dict(sd)
    port = mpnn.load_mpnn_state_dict(
        mpnn.CAProteinMPNN(hidden=HIDDEN, k=K, device="cpu"), sd)
    coords, mask, tokens, order = inputs(seed=5)
    want = jm.apply(params, coords, tokens, order, mask)
    with torch.no_grad():
        got = port(t(coords), t(tokens, torch.long), t(order, torch.long))
    close(got, want)
    # the public names are the port's own: nothing unknown, nothing missing
    assert set(port.state_dict()) == set(sd)
    with pytest.raises(KeyError):
        mpnn.load_mpnn_state_dict(port, {**sd, "decoder_layers.0.W4.weight":
                                         np.zeros((2, 2))})
    with pytest.raises(KeyError):
        mpnn.load_mpnn_state_dict(port, {k: v for k, v in sd.items()
                                         if k != "W_e.bias"})
    with pytest.raises(ValueError):
        mpnn.load_mpnn_state_dict(port, {**sd, "W_e.bias": np.zeros(3)})


def test_npz_read_by_both_loaders(twins, tmp_path):
    jm, params, _ = twins
    flat = {"/".join(str(p.key) for p in kp): np.asarray(leaf)
            for kp, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}
    path = str(tmp_path / "mpnn.npz")
    np.savez(path, **flat)
    jax_scorer = jax_mpnn.load_mpnn_scorer(npz_path=path, hidden=HIDDEN, k=K)
    scorer = mpnn.load_mpnn_scorer(npz_path=path, hidden=HIDDEN, k=K,
                                   device="cpu")
    coords, mask, tokens, order = inputs(seed=6)
    want = jm.apply(jax_scorer.params, coords, tokens, order, mask)
    with torch.no_grad():
        got = scorer.model(t(coords), t(tokens, torch.long),
                           t(order, torch.long))
    close(got, want)
    bad = dict(flat)
    k0 = next(k for k in bad if bad[k].ndim == 2)
    bad[k0] = bad[k0][:, :1]
    np.savez(str(tmp_path / "bad.npz"), **bad)
    with pytest.raises(ValueError):
        mpnn.load_mpnn_scorer(npz_path=str(tmp_path / "bad.npz"),
                              hidden=HIDDEN, k=K, device="cpu")


def test_published_width_parameter_count_matches_jax():
    shapes = jax.eval_shape(jax_mpnn.CAProteinMPNN().init,
                            jax.random.PRNGKey(0), jnp.zeros((8, 3)),
                            jnp.zeros(8, jnp.int32), jnp.arange(8),
                            jnp.ones(8))
    n_jax = sum(int(np.prod(x.shape))
                for x in jax.tree_util.tree_leaves(shapes))
    port = mpnn.CAProteinMPNN(device="meta")
    assert sum(p.numel() for p in port.parameters()) == n_jax \
        == PUBLISHED_PARAMS


@pytest.fixture(scope="module")
def scorer():
    return mpnn.load_mpnn_scorer(hidden=HIDDEN, k=K, seed=0, device="cpu")


def test_scorer_properties(scorer):
    """The JAX tests' properties of any weights: shapes, log-softmax rows,
    seed determinism, rigid-motion invariance, causality."""
    coords = chain(14, 7).astype(np.float32)
    tokens = scorer.sample(coords, seed=3)
    assert tokens.shape == (14,) and tokens.min() >= 0 and tokens.max() < 21
    np.testing.assert_array_equal(tokens, scorer.sample(coords, seed=3))
    lp = scorer.log_probs(coords, tokens, seed=1)
    np.testing.assert_allclose(np.exp(lp).sum(-1), 1.0, rtol=1e-5)
    q, _ = np.linalg.qr(np.random.default_rng(3).normal(size=(3, 3)))
    moved = coords @ q.T.astype(np.float32) + np.float32([10., -5., 3.])
    np.testing.assert_allclose(scorer.log_probs(moved, tokens, seed=1), lp,
                               atol=2e-4)
    order = scorer._order(14, 1)
    later = tokens.copy()
    later[order[-1]] = (later[order[-1]] + 5) % 21
    lp2 = scorer.log_probs(coords, later, seed=1)
    mid = order[7]
    np.testing.assert_allclose(lp2[mid], lp[mid], atol=1e-6)


# --- self-consistency --------------------------------------------------


def test_proteinmpnn_scores_match_jax():
    coords = chain(16, 8)
    for kw in ({}, {"motif_inds": [1, 4, 9], "motif_res": "WHY"}):
        want = jax_sc.proteinmpnn_scores(coords, jax_sc.StubScorer(),
                                         n_seq=3, **kw)
        got = sc.proteinmpnn_scores(coords, sc.StubScorer(), n_seq=3, **kw)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
    with pytest.raises(ValueError):
        sc.proteinmpnn_scores(coords, sc.StubScorer(), n_seq=1,
                              motif_inds=[1, 4], motif_res="W")


def test_motif_positions_keep_their_residues(scorer):
    coords = chain(16, 9)
    scores, seqs = sc.proteinmpnn_scores(coords, scorer, n_seq=2,
                                         motif_inds=[2, 5, 9],
                                         motif_res="WHY")
    assert all([s[i] for i in (2, 5, 9)] == list("WHY") for s in seqs)
    assert np.all((scores > 0) & (scores <= 1))


FAKE_COLABFOLD = """#!%PY%
import csv, json, math, os, sys
args = [a for a in sys.argv[1:] if not a.startswith("--")]
seqs_csv, out_dir = args
os.makedirs(out_dir, exist_ok=True)
for row in csv.DictReader(open(seqs_csv)):
    sid, L = row["id"], len(row["sequence"])
    json.dump({"plddt": [80.0 + (i % 5) for i in range(L)],
               "max_pae": 4.5, "ptm": 0.87},
              open(os.path.join(out_dir, sid + "_scores_rank_001_m.json"),
                   "w"))
    lines = ["ATOM  %5d  CA  ALA A%4d    %8.3f%8.3f%8.3f  1.00  0.00"
             "           C" % (i + 1, i + 1, 2.3 * math.cos(0.6 * i),
                                2.3 * math.sin(0.6 * i), 1.5 * i)
             for i in range(L)]
    open(os.path.join(out_dir, sid + "_relaxed_rank_001_m.pdb"),
         "w").write("\\n".join(lines + ["END"]) + "\\n")
"""


@pytest.mark.parametrize("fold", [False, True])
def test_self_consistency_eval_matches_jax(tmp_path, fold):
    exe = tmp_path / "colabfold_batch"
    exe.write_text(FAKE_COLABFOLD.replace("%PY%", sys.executable))
    exe.chmod(exe.stat().st_mode | stat.S_IXUSR)
    structures = {"sample_000": chain(20, 10), "sample_001": chain(24, 11)}
    rows = {}
    for name, mod in (("jax", jax_sc), ("port", sc)):
        d = tmp_path / name
        d.mkdir()
        rows[name] = mod.self_consistency_eval(
            structures, str(d), scorer=mod.StubScorer(), n_seq=2,
            colabfold_executable=str(exe), run_fold=fold)
    for got, want in zip(rows["port"], rows["jax"]):
        # scTM and scRMSD come from the native scans, which the two
        # packages build with different flags (the JAX one with
        # -march=native): equal to the last bits
        for key in ("scTM", "scRMSD"):
            assert got.pop(key, None) == pytest.approx(want.pop(key, None),
                                                       abs=1e-12)
        assert got == want
    assert (tmp_path / "port" / "protein_mpnn_seqs.csv").read_text() == \
        (tmp_path / "jax" / "protein_mpnn_seqs.csv").read_text()
    if fold:
        assert all(r["pTM"] == [0.87, 0.87] for r in rows["port"])
    assert sc.load_proteinmpnn_scorer() is None   # no weights, no random
    assert sc.self_consistency_eval(structures, str(tmp_path),
                                    scorer=None) == [{}, {}]


# --- the evaluation stages and the CLI ---------------------------------


@pytest.mark.parametrize("stage", [s.name for s in evaluate.DEFAULT_STAGES])
def test_stage_matches_jax(stage):
    port = {s.name: s for s in evaluate.DEFAULT_STAGES}[stage]
    ref = {s.name: s for s in jax_evaluate.DEFAULT_STAGES}[stage]
    for coords in (chain(30, 12), chain(50, 13) * 0.3):
        assert port(coords) == ref(coords)


def test_novelty_stage_and_process_pool_match_jax():
    """The novelty stage pickles into the port's spawn workers, and the pool
    gives the serial rows, which equal the JAX pipeline's."""
    structures = chains(3)
    train = chains(2, seed=9)
    pipeline = evaluate.EvaluationPipeline(
        list(evaluate.DEFAULT_STAGES) + [evaluate.make_novelty_stage(train)])
    serial = pipeline.eval_many(structures, n_jobs=1)
    assert pipeline.eval_many(structures, n_jobs=2,
                              backend="process") == serial
    want = jax_evaluate.EvaluationPipeline(
        list(jax_evaluate.DEFAULT_STAGES)
        + [jax_evaluate.make_novelty_stage(train)]).eval_many(structures,
                                                               n_jobs=1)
    assert [r.keys() for r in serial] == [r.keys() for r in want]
    for a, b in zip(serial, want):
        for key in a:
            if key.startswith("novelty_"):
                assert a[key] == pytest.approx(b[key], abs=1e-9)
            else:
                assert a[key] == b[key]


def test_main_summary_matches_jax(tmp_path):
    """`main` with --novelty --compare_train on one sample dir and training
    set, run by both packages: the same summary_stats.json and
    sample_stats.csv columns."""
    samples = chains(4, seed=20)
    train = chains(6, seed=30, base=36)
    summaries = {}
    for name, mod in (("jax", jax_evaluate), ("port", evaluate)):
        sample_dir = tmp_path / name / "samples"
        train_root = tmp_path / name / "scope"
        sample_dir.mkdir(parents=True)
        train_root.mkdir()
        for i, (k, v) in enumerate(samples.items()):
            np.save(sample_dir / f"sample_{i:04d}.npy", v)
        for k, v in train.items():
            np.save(train_root / f"{k}.npy", v)
        mod.main(["--sample_dir", str(sample_dir), "--train_root",
                  str(train_root), "--novelty", "--compare_train",
                  "--max_train", "5"])
        summaries[name] = json.loads(
            (sample_dir / "summary_stats.json").read_text())
        assert (tmp_path / name / "scope_stats.csv").exists()
        assert len(evaluate._read_csv(str(sample_dir
                                          / "sample_stats.csv"))) == 4
    port, ref = summaries["port"], summaries["jax"]
    assert port.keys() == ref.keys()
    assert any(k.endswith("_w1_vs_train") for k in port)
    for key in port:
        assert port[key] == pytest.approx(ref[key], abs=1e-9), key


# --- the native novelty scan -------------------------------------------


@pytest.mark.parametrize("fn", ["kabsch_alignment", "rmsd", "tm_score",
                                "gdt_score"])
def test_native_metric_matches_jax(fn):
    p = chain(30, 40)
    rot, _ = np.linalg.qr(np.random.default_rng(1).normal(size=(3, 3)))
    q = (p + np.random.default_rng(2).normal(0, 0.5, p.shape)) @ rot.T
    if fn == "kabsch_alignment":
        np.testing.assert_allclose(novelty.kabsch_alignment(p, q),
                                   novelty._np_kabsch_alignment(p, q),
                                   atol=1e-9)
    got = getattr(novelty, fn)(p, q)
    np.testing.assert_allclose(got, getattr(jax_novelty, fn)(p, q),
                               atol=1e-12)


def test_find_closest_matches_jax_and_numpy():
    train = chains(5, seed=50, base=18)
    train["same"] = chain(26, 60)
    for query in (chain(26, 60) @ np.diag([1.0, -1.0, -1.0]),
                  chain(22, 61), chain(40, 62)):
        got = novelty.find_closest_structure(query, train)
        want = jax_novelty.find_closest_structure(query, train)
        plain = novelty._np_find_closest(
            novelty._prep(query), list(train),
            [novelty._prep(v) for v in train.values()])
        for key in got:
            if key.endswith("_match"):
                assert got[key] == want[key] == plain[key], key
            else:
                assert got[key] == pytest.approx(want[key], abs=1e-12)
                assert got[key] == pytest.approx(plain[key], abs=1e-9)
    assert got["tm_score"] <= 1.0


def test_novelty_build_raises(tmp_path, monkeypatch):
    """A source that does not compile raises: no numpy fallback."""
    bad = tmp_path / "novelty.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(novelty, "SRC", bad)
    monkeypatch.setattr(novelty, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        novelty.build()
    assert not list((tmp_path / "build").glob("*.so"))


def test_native_source_is_the_jax_packages():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "tpu_diffusion", "native",
                           "novelty.cpp"), "rb") as f:
        assert novelty.SRC.read_bytes() == f.read()
