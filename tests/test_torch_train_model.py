"""Port parity for training: ``repro_torch.models.gnn`` (``forward`` with
``fake_bits``, ``forward_int``), ``train.optimizer``, ``train.trainer`` and
the ``convert`` helpers that carry the reference's optimizer state across,
against the reference (``repro.models.gnn``, ``repro.train``), on the
reference tests' proteins graph (scale 0.05, 8 parts, 4 a batch) with
stochastic rounding off.

Tolerances, and why:
  * the integer path's loss and gradients for one step (grad_bits 0 and
    8), and the params after each of 5 AdamW steps (every step from the
    reference's params and optimizer state, carried across by
    ``convert``): rtol 1e-4, atol 1e-6.
    Its forward is integer and bit-exact; the float backward and the loss's
    reductions differ in the last bits.
  * the fp32 path (``qat=False``), 5 steps of ``trainer.train`` end to end:
    rtol 1e-4, atol 1e-6.
  * the fake-quant path, whole model: loss rtol 1e-4; gradients and params
    after each step within 5e-3 of the reference, relative in each leaf's
    norm (the reference's own int-against-fake bound). Its float GEMMs run
    in XLA's and torch's orders, which differ in the last bit, and a last-
    bit difference can move a value across a floor or move the STE gate at
    a calibrated maximum (``x < zero + scale * 2**bits`` is decided by the
    last bit there), which changes a gradient by a whole level. Each layer
    alone, fed the reference's input, is held at rtol 1e-5 and an atol of
    1e-5 of the tensor's largest value (its weight gradients are float
    GEMMs over the batch's 1152 nodes, summed in another order).
The reference runs op by op (not under ``jax.jit``, whose fusions round
differently again) on its ``xla_dot`` engine.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.graph import batching as jbatching  # noqa: E402
from repro.graph import datasets as jdatasets  # noqa: E402
from repro.graph import partition as jpartition  # noqa: E402
from repro.models import gnn as jgnn  # noqa: E402
from repro.train import intpath as jintpath  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import trainer as jtrainer  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.benchmarks import table2_accuracy  # noqa: E402
from repro_torch.graph import datasets, partition  # noqa: E402
from repro_torch.models import gnn  # noqa: E402
from repro_torch.train import intpath  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import trainer  # noqa: E402

BITS = (2, 4, 8)
STEP_TOL = dict(rtol=1e-4, atol=1e-6)
FAKE_NORM_TOL = 5e-3
OPT_KW = dict(lr=1e-2, weight_decay=1e-4, grad_clip=1.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once: one torch thread
    each keeps them from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup():
    """(reference data, parts, batches), (port data, parts, batches)."""
    out = []
    for ds, part, tr in ((jdatasets, jpartition, jtrainer),
                         (datasets, partition, trainer)):
        data = ds.load("proteins", scale=0.05, seed=0)
        parts = part.partition(data.csr, 8)
        out.append((data, parts, tr.prepare_batches(data, parts, batch_size=4)))
    return out


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cfgs(data, bits, model="gcn"):
    mk = (jgnn.GNNConfig.paper_gcn if model == "gcn"
          else jgnn.GNNConfig.paper_gin)
    cfg = mk(data.features.shape[1], data.n_classes, x_bits=bits, w_bits=bits)
    return cfg, gnn.GNNConfig(**dataclasses.asdict(cfg))


def _dbatches(path, bits, b_j, b_t, caps):
    """The reference's and the port's device batch for one path."""
    if path == "int":
        return ({"art": jintpath.build_artifacts(b_j, bits, **caps),
                 "y": jnp.asarray(b_j.labels), "mask": jnp.asarray(b_j.train_mask)},
                {"art": intpath.build_artifacts(b_t, bits, device="cpu", **caps),
                 "y": torch.as_tensor(b_t.labels),
                 "mask": torch.as_tensor(b_t.train_mask)})
    return jtrainer.make_device_batch(b_j), trainer.make_device_batch(b_t, device="cpu")


def _ref_loss_and_grads(params, db, cfg, path, qat=True, grad_bits=0):
    if path == "int":
        args = (False, "int_bitserial", grad_bits, False, None, "xla_dot")
    else:
        args = (qat,)
    (loss, _), grads = jax.value_and_grad(jtrainer.loss_fn, has_aux=True)(
        params, db, cfg, *args)
    return loss, grads


def _port_loss_and_grads(params, db, cfg, path, qat=True, grad_bits=0):
    p = trainer._with_grad(params)
    loss, _ = (trainer.loss_fn(p, db, cfg, False, "int_bitserial", grad_bits)
               if path == "int" else trainer.loss_fn(p, db, cfg, qat))
    return loss.detach(), trainer._grads(loss, p)


def _norm_rel(got, want):
    den = max(float(np.linalg.norm(want)), 1e-12)
    return float(np.linalg.norm(got - want)) / den


def _hold(got_tree, want_tree, norm_tol=None):
    got = convert.params_to_numpy(got_tree)
    for layer, p in want_tree.items():
        for k, want in p.items():
            if norm_tol is None:
                np.testing.assert_allclose(got[layer][k], np.asarray(want),
                                           err_msg=f"{layer}.{k}", **STEP_TOL)
            else:
                assert _norm_rel(got[layer][k], np.asarray(want)) <= norm_tol, (
                    layer, k)


# ------------------------------------------------------------------ model

def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("model", ("gcn", "gin"))
@pytest.mark.parametrize("bits", BITS)
def test_fake_path_forward_matches_reference(setup, model, bits):
    """The fake-quantized forward of both models, and the plain fp32 one."""
    (jd, _, jb), (_, _, tb) = setup
    cfg_j, cfg_t = _cfgs(jd, bits, model)
    params = jgnn.init_params(jax.random.PRNGKey(0), cfg_j)
    pt = convert.params_from_jax(_np(params), device="cpu")
    db_j, db_t = _dbatches("fake", bits, jb[0], tb[0], {})
    for fake in (True, False):
        want = np.asarray(jgnn.forward(params, db_j["adj"], db_j["x"],
                                       db_j["inv_deg"], cfg_j, fake_bits=fake))
        got = gnn.forward(pt, db_t["adj"], db_t["x"], db_t["inv_deg"], cfg_t,
                          fake_bits=fake).numpy()
        if fake:
            assert _norm_rel(got, want) <= FAKE_NORM_TOL
        else:
            _close(got, want)


@pytest.mark.parametrize("grad_bits", (0, 8))
@pytest.mark.parametrize("bits", BITS)
def test_int_path_loss_and_grads_match_reference(setup, bits, grad_bits):
    (jd, _, jb), (_, _, tb) = setup
    cfg_j, cfg_t = _cfgs(jd, bits)
    params = jgnn.init_params(jax.random.PRNGKey(0), cfg_j)
    caps = dict(zip(("block_pad", "rem_pad"), jintpath.batch_caps(jb)))
    db_j, db_t = _dbatches("int", bits, jb[0], tb[0], caps)
    loss_j, g_j = _ref_loss_and_grads(params, db_j, cfg_j, "int", grad_bits=grad_bits)
    loss_t, g_t = _port_loss_and_grads(
        convert.params_from_jax(_np(params), device="cpu"), db_t, cfg_t, "int",
        grad_bits=grad_bits)
    assert float(loss_t) == pytest.approx(float(loss_j), rel=1e-4)
    _hold(g_t, g_j)
    # the same logits through the artifacts as through gnn.forward's router
    logits = gnn.forward(convert.params_from_jax(_np(params), device="cpu"),
                         db_t["art"], None, None, cfg_t, path="int_bitserial")
    np.testing.assert_array_equal(
        logits.detach().numpy(),
        gnn.forward_int(convert.params_from_jax(_np(params), device="cpu"),
                        db_t["art"], cfg_t).detach().numpy())


@pytest.mark.parametrize("bits", BITS)
def test_fake_path_loss_and_grads_match_reference(setup, bits):
    (jd, _, jb), (_, _, tb) = setup
    cfg_j, cfg_t = _cfgs(jd, bits)
    params = jgnn.init_params(jax.random.PRNGKey(0), cfg_j)
    db_j, db_t = _dbatches("fake", bits, jb[0], tb[0], {})
    loss_j, g_j = _ref_loss_and_grads(params, db_j, cfg_j, "fake")
    loss_t, g_t = _port_loss_and_grads(
        convert.params_from_jax(_np(params), device="cpu"), db_t, cfg_t, "fake")
    assert float(loss_t) == pytest.approx(float(loss_j), rel=1e-4)
    _hold(g_t, g_j, norm_tol=FAKE_NORM_TOL)


def test_forward_int_covers_gcn_only(setup):
    (jd, _, _), (_, _, tb) = setup
    _, cfg = _cfgs(jd, 4, "gin")
    art = intpath.build_artifacts(tb[0], 4, device="cpu")
    params = gnn.init_params(cfg, generator=torch.Generator().manual_seed(0),
                             device="cpu")
    with pytest.raises(NotImplementedError, match="cluster-GCN"):
        gnn.forward_int(params, art, cfg)


# ------------------------------------------------------ steps and AdamW

@pytest.mark.parametrize("path,bits", [("int", 2), ("int", 4), ("int", 8),
                                       ("fake", 4), ("fake", 8), ("fp32", 8)])
def test_adamw_steps_match_reference(setup, path, bits):
    """5 steps over the batch order of ``batch_iterator``; before each, the
    reference's params and AdamW state are carried to the port."""
    (jd, _, jb), (_, _, tb) = setup
    cfg_j, cfg_t = _cfgs(jd, bits)
    params = jgnn.init_params(jax.random.PRNGKey(0), cfg_j)
    state = jopt.adamw_init(params)
    ocfg_j, ocfg_t = jopt.AdamWConfig(**OPT_KW), opt.AdamWConfig(**OPT_KW)
    caps = dict(zip(("block_pad", "rem_pad"), jintpath.batch_caps(jb)))
    qat = path == "fake"
    pos = {id(b): i for i, b in enumerate(jb)}
    order = [pos[id(b)] for _, (_, b) in zip(range(5), jbatching.batch_iterator(jb))]
    for step, i in enumerate(order):
        p_t = convert.params_from_jax(_np(params), device="cpu")
        s_t = convert.adamw_state_from_jax(_np(state), device="cpu")
        assert int(s_t["step"]) == step
        db_j, db_t = _dbatches(path, bits, jb[i], tb[i], caps)
        loss_j, g_j = _ref_loss_and_grads(params, db_j, cfg_j, path, qat)
        params, state = jopt.adamw_update(params, g_j, state, ocfg_j)
        if path == "int":
            p_t, s_t, _, loss_t, _ = trainer.train_step_int(
                p_t, s_t, None, db_t, None, cfg_t, ocfg_t, 0, False, 0, None)
        else:
            p_t, s_t, loss_t, _ = trainer.train_step(p_t, s_t, db_t, cfg_t,
                                                     ocfg_t, qat)
        assert float(loss_t) == pytest.approx(float(loss_j), rel=1e-4)
        _hold(p_t, params, norm_tol=FAKE_NORM_TOL if qat else None)
        _hold(s_t["mu"], state["mu"], norm_tol=FAKE_NORM_TOL if qat else None)
        assert int(s_t["step"]) == step + 1


def _tree(rng, shapes):
    return {f"layer{i}": {k: rng.standard_normal(s).astype(np.float32)
                          for k, s in layer.items()}
            for i, layer in enumerate(shapes)}


SHAPES = ({"w": (7, 5), "b": (5,)}, {"w": (5, 3), "b": (3,)})


@pytest.mark.parametrize("clip,decay", [(0.0, 0.0), (1.0, 1e-2), (0.05, 0.0)])
def test_adamw_update_and_clip_match_reference(clip, decay):
    rng = np.random.default_rng(3)
    params = _tree(rng, SHAPES)
    cfg = dict(lr=1e-2, weight_decay=decay, grad_clip=clip)
    pj, sj = params, jopt.adamw_init(params)
    pt = convert.params_from_jax(params, device="cpu")
    st = opt.adamw_init(pt)
    for _ in range(5):
        grads = _tree(rng, SHAPES)
        pj, sj = jopt.adamw_update(pj, grads, sj, jopt.AdamWConfig(**cfg))
        pt, st = opt.adamw_update(pt, convert.params_from_jax(grads, device="cpu"),
                                  st, opt.AdamWConfig(**cfg))
        got = convert.params_to_numpy(pt)
        for layer in pj:
            for k in pj[layer]:
                np.testing.assert_allclose(got[layer][k], np.asarray(pj[layer][k]),
                                           rtol=1e-5, atol=1e-7)
    assert int(st["step"]) == 5 and st["step"].dtype == torch.int32
    grads = _tree(rng, SHAPES)
    cj, nj = jopt.clip_by_global_norm(grads, 0.5)
    ct, nt = opt.clip_by_global_norm(convert.params_from_jax(grads, device="cpu"), 0.5)
    assert float(nt) == pytest.approx(float(nj), rel=1e-6)
    for layer in cj:
        for k in cj[layer]:
            np.testing.assert_allclose(ct[layer][k].numpy(), np.asarray(cj[layer][k]),
                                       rtol=1e-6)


@pytest.mark.parametrize("nbits", (8, 4))
def test_compress_grads_round_trip_and_error_feedback(nbits):
    rng = np.random.default_rng(nbits)
    grads = [_tree(rng, SHAPES) for _ in range(3)]
    sj = jopt.compression_init(grads[0])
    st = convert.compression_state_from_jax(_np(sj.residual), device="cpu")
    for g in grads:
        qj, scj, sj = jopt.compress_grads(g, sj, nbits)
        qt, sct, st = opt.compress_grads(convert.params_from_jax(g, device="cpu"),
                                         st, nbits)
        dj = jopt.decompress_grads(qj, scj)
        dt = opt.decompress_grads(qt, sct)
        for layer in g:
            for k in g[layer]:
                assert qt[layer][k].dtype == torch.int8
                np.testing.assert_array_equal(qt[layer][k].numpy(),
                                              np.asarray(qj[layer][k]))
                np.testing.assert_array_equal(sct[layer][k].numpy(),
                                              np.asarray(scj[layer][k]))
                np.testing.assert_array_equal(st.residual[layer][k].numpy(),
                                              np.asarray(sj.residual[layer][k]))
                # decompressed + residual is what went in: the error is fed back
                np.testing.assert_allclose(
                    dt[layer][k].numpy() + st.residual[layer][k].numpy(),
                    np.asarray(dj[layer][k]) + np.asarray(sj.residual[layer][k]),
                    rtol=0, atol=0)
    # the reference's state carried across mid-run continues identically
    g = _tree(rng, SHAPES)
    carried = convert.compression_state_from_jax(_np(sj.residual), device="cpu")
    q_a = opt.compress_grads(convert.params_from_jax(g, device="cpu"), carried, nbits)[0]
    q_b = opt.compress_grads(convert.params_from_jax(g, device="cpu"), st, nbits)[0]
    assert all(torch.equal(q_a[l][k], q_b[l][k]) for l in q_a for k in q_a[l])


def test_convert_carries_state_both_ways():
    rng = np.random.default_rng(0)
    params = _tree(rng, SHAPES)
    state = jopt.adamw_init(params)
    state = jopt.adamw_update(params, _tree(rng, SHAPES), state,
                              jopt.AdamWConfig())[1]
    st = convert.adamw_state_from_jax(_np(state), device="cpu")
    assert int(st["step"]) == 1 and st["step"].dtype == torch.int32
    back = convert.params_to_numpy(st["nu"])
    for layer in params:
        for k in params[layer]:
            np.testing.assert_array_equal(back[layer][k], np.asarray(state["nu"][layer][k]))
            assert back[layer][k].dtype == np.float32
    again = convert.params_to_numpy(convert.params_from_jax(params, device="cpu"))
    for layer in params:
        for k in params[layer]:
            np.testing.assert_array_equal(again[layer][k], params[layer][k])


# ---------------------------------------------------------------- trainer

def test_train_fp32_matches_reference_end_to_end(setup, monkeypatch):
    """``trainer.train`` for 5 steps from the reference's initial weights
    (no quantization, so nothing rounds across a floor): the history's
    losses and the final params."""
    (jd, jp, _), (td, tp, _) = setup
    cfg_j, cfg_t = _cfgs(jd, 8)
    tc_j = jtrainer.TrainConfig(steps=5, qat=False, log_every=2, seed=0)
    tc_t = trainer.TrainConfig(steps=5, qat=False, log_every=2, seed=0)
    init = jgnn.init_params(jax.random.PRNGKey(0), cfg_j)
    monkeypatch.setattr(trainer.gnn, "init_params", lambda cfg, generator, device:
                        convert.params_from_jax(_np(init), device=device))
    p_j, s_j, h_j = jtrainer.train(jd, jp, cfg_j, tc_j, batch_size=4)
    p_t, s_t, h_t = trainer.train(td, tp, cfg_t, tc_t, batch_size=4,
                                  device="cpu")
    assert [r["step"] for r in h_t] == [r["step"] for r in h_j] == [0, 2, 4]
    for a, b in zip(h_t, h_j):
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-4)
        assert a["acc"] == pytest.approx(b["acc"], abs=1e-6)
    _hold(p_t, p_j)
    assert int(s_t["step"]) == 5


def test_convergence_regression_both_paths(setup):
    """The reference's 30-step regression on the port: both paths converge
    to matched train loss and test accuracy."""
    _, (td, tp, _) = setup
    _, cfg = _cfgs(td, 4)
    acc, hist = {}, {}
    for arm, tcfg in {
        "fake": trainer.TrainConfig(steps=30, log_every=29, seed=0),
        "int": trainer.TrainConfig(steps=30, log_every=29, seed=0,
                                   path="int_bitserial"),
    }.items():
        params, _, h = trainer.train(td, tp, cfg, tcfg, batch_size=4, device="cpu")
        hist[arm] = h
        acc[arm] = trainer.evaluate(
            params, td, tp, cfg, qat=True, device="cpu",
            path="int_bitserial" if arm == "int" else "fp32_dense")
    for arm in ("fake", "int"):
        assert np.isfinite(hist[arm][-1]["loss"])
        assert hist[arm][-1]["loss"] < hist[arm][0]["loss"] * 0.6, arm
    assert acc["int"] >= acc["fake"] - 0.05


@pytest.mark.parametrize("path", ("fp32_dense", "int_bitserial"))
def test_evaluate_matches_reference(setup, path):
    (jd, jp, _), (td, tp, _) = setup
    cfg_j, cfg_t = _cfgs(jd, 4)
    params = jgnn.init_params(jax.random.PRNGKey(1), cfg_j)
    want = jtrainer.evaluate(params, jd, jp, cfg_j, qat=True, path=path)
    got = trainer.evaluate(convert.params_from_jax(_np(params), device="cpu"),
                           td, tp, cfg_t, qat=True, path=path, device="cpu")
    assert got == want


def test_stochastic_training_repeats_per_seed_and_compresses(setup):
    _, (td, tp, _) = setup
    _, cfg = _cfgs(td, 4)

    def run(seed, **kw):
        tcfg = trainer.TrainConfig(steps=3, log_every=1, seed=seed,
                                   path="int_bitserial", stochastic=True,
                                   grad_bits=8, **kw)
        return trainer.train(td, tp, cfg, tcfg, batch_size=4, device="cpu")

    def flat(p):
        return torch.cat([v.reshape(-1) for layer in p.values()
                          for v in layer.values()])

    (p_a, _, h_a), (p_b, _, h_b), (p_c, _, _) = run(0), run(0), run(1)
    assert [r["loss"] for r in h_a] == [r["loss"] for r in h_b]
    assert torch.equal(flat(p_a), flat(p_b))
    assert not torch.equal(flat(p_a), flat(p_c))
    p_d, _, h_d = run(0, grad_compress_bits=8)
    assert all(np.isfinite(r["loss"]) for r in h_d)
    assert not torch.equal(flat(p_a), flat(p_d))


def test_table2_emits_the_reference_names():
    from repro_torch.benchmarks import common

    start = len(common.RECORDS)
    table2_accuracy.main(device="cpu", scale=0.005, steps=2,
                         dsets=("ogbn-arxiv",), bits_list=("fp32", 4))
    recs = common.RECORDS[start:]
    assert [r["name"] for r in recs] == ["table2_ogbn-arxiv_fp32",
                                         "table2_ogbn-arxiv_4",
                                         "table2_ogbn-arxiv_4_int"]
    assert all(r["unit"] == "test_acc" and 0.0 <= r["value"] <= 1.0 for r in recs)
    assert recs[-1]["arm"] == "int" and "final_loss" in recs[0]
