"""The training substrate on the CPU, held against the reference.

The port's ``repro_torch.train`` (optimizers, schedules, clipping, int8
error feedback, checkpoints, the train step and the loop, the watchdog and
the restart supervisor) against ``repro.train`` on the reference's own
test config (``tests/test_train.py``: a 2-layer GQA LM, d 32, vocab 128)
and weights carried across with ``convert``:

* each optimizer (SGD-M, Nesterov, AdamW, Adafactor with its factored
  branch) fed the reference's own gradients for two updates: params and
  state to rtol 1e-6 (``OPT_TOL``: near zero, 1e-7 of the leaf's max);
  on a bf16 copy of the params, at least 99.9 % of the new params bit for
  bit and the rest one bf16 ulp apart;
* ``warmup_cosine``, ``constant_lr``, ``global_norm`` and
  ``clip_by_norm``; ``quantize_int8`` (q equal, scales within one ulp)
  and the error-feedback transform over several steps;
* one ``make_train_step`` step from the converted train state (the
  reference's after three steps; plain,
  ``accum=2`` and ``compress=True``) at the fp32 compute policy to rtol
  1e-4 / atol 1e-4 of each leaf's max (``STEP_TOL``: the fp32 gradient of
  this config is itself only good to about 1e-5 of the max; compressed,
  at most 1 % of a leaf's entries one int8 step apart), and the
  compressed step on a loss both packages differentiate exactly (EF
  buffer included) to the optimizer tolerance;
* the reference's own behaviour tests, on the port and on the reference
  test's initial weights (``T.init(CFG, PRNGKey(0))``, carried across;
  its thresholds were set for them): 25 steps lower the
  loss for each optimizer, accumulation equals the big batch, compressed
  training keeps the plain loss, restart and fault injection are bit for
  bit, a corrupted leaf raises ``IOError``, the watchdog flags step 15;
  ``save_async`` snapshots before it returns, ``latest_step`` ignores
  uncommitted steps and ``keep_last`` collects the old ones;
* checkpoints cross both ways, bit for bit, with the reference's leaf
  names: reference -> port and port -> reference.

``compressed_psum`` runs across four gloo ranks in
``tests/test_torch_sharded_slice.py``'s spawn.
"""
from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from test_torch_reference import reference  # noqa: F401  (fixture)

from repro_torch.configs.base import LMConfig
from repro_torch.convert import lm_params_from_arrays, train_state_from_arrays
from repro_torch.data.lm import LMStream
from repro_torch.models import transformer as PT
from repro_torch.train import checkpoint as C
from repro_torch.train import optim
from repro_torch.train.compression import (dequantize_int8,
                                           make_ef_transform, quantize_int8)
from repro_torch.train.fault import (FaultInjected, Watchdog,
                                     make_fault_injector, run_with_restart)
from repro_torch.train.loop import (TrainState, init_state, make_train_step,
                                    train)
from repro_torch.train.tree import leaves, map_trees

CFG_KW = dict(name="t", n_layers=2, d_model=32, n_heads=2, n_kv_heads=1,
              d_head=16, d_ff=64, vocab=128, scan_layers=True, remat=False)
CFG = LMConfig(**CFG_KW)
STREAM = LMStream(CFG.vocab, 16, 4, seed=0)
# a whole step at the fp32 policy: rtol 1e-4 and an atol of 1e-4 of each
# leaf's max abs.  The gradient of this config is ill-conditioned in fp32:
# against a float64 evaluation of the same loss, the reference's fp32
# gradient is off by up to 9.5e-6 of a leaf's max and the port's by up to
# 2.0e-5 (w_q), so 1e-5 of the max is below what either package holds
STEP_TOL = dict(rtol=1e-4, atol=1e-4)
# optimizers on the same gradients: rtol 1e-6, and for entries near zero
# an atol of 1e-7 of the leaf's max abs (below one fp32 ulp of its largest
# entry; Adafactor's means add in another order than XLA's)
OPT_TOL = dict(rtol=1e-6, atol_of_max=1e-7)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy().copy()
    return np.asarray(x, dtype=np.float32)


def _paths(tree, prefix="") -> dict:
    """path -> leaf of a nested dict (JAX and port trees alike)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_paths(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _close_tree(port, ref, rtol, atol_of_max=0.0, flips=0.0,
                atol_floor=0.0):
    """Every leaf of ``port`` against ``ref``'s: rtol, and an atol of
    ``atol_of_max`` times the reference leaf's max abs, never below
    ``atol_floor``; at most a share ``flips`` of a leaf's entries may lie
    outside (int8 rounding that went the other way on a gradient a
    rounding apart)."""
    p, r = _paths(port), _paths(ref)
    assert p.keys() == r.keys()
    for k in r:
        a, b = _np(p[k]), _np(r[k])
        assert a.shape == b.shape, k
        atol = max(atol_of_max * float(np.abs(b).max()) if b.size else 0.0,
                   atol_floor)
        if not flips:
            np.testing.assert_allclose(a, b, rtol=rtol, atol=atol,
                                       err_msg=k)
            continue
        bad = int((np.abs(a - b) > atol + rtol * np.abs(b)).sum())
        assert bad <= flips * b.size, (k, bad, b.size)


def _loss(p, b):
    return PT.loss_fn(p, b, CFG)


def _init(arrays):
    """The reference test's initial weights in the port's tree."""
    return lm_params_from_arrays(arrays, CFG, device="cpu")


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def arrays(reference):
    return _setup(reference)["arrays"]


_SETUP: dict = {}


def _setup(reference):
    """The reference's config, its own initial weights (its test's
    ``T.init(CFG, PRNGKey(0))``, as numpy) and its gradient of the loss on
    batch 0."""
    if "g" in _SETUP:
        return _SETUP
    jax = pytest.importorskip("jax")
    rcfg = reference.configs_base.LMConfig(**CFG_KW)
    T = reference.transformer
    arrays = jax.tree.map(np.asarray, T.init(rcfg, jax.random.PRNGKey(0)))
    batch = STREAM.batch_at(0)
    grad = jax.jit(jax.grad(lambda p: T.loss_fn(p, batch, rcfg)[0]))
    g = grad(jax.tree.map(jax.numpy.asarray, arrays))
    _SETUP.update(rcfg=rcfg, arrays=arrays, batch=batch,
                  g=jax.tree.map(np.asarray, g))
    return _SETUP


def _opts(ns, name):
    o = ns.optim if hasattr(ns, "optim") else ns
    return {
        "adamw": lambda: o.adamw(o.warmup_cosine(1e-3, 1, 10)),
        "adamw_const": lambda: o.adamw(o.constant_lr(1e-3)),
        "adafactor": lambda: o.adafactor(o.constant_lr(1e-2),
                                         min_dim_factored=16,
                                         weight_decay=0.01),
        "sgd": lambda: o.sgd(o.constant_lr(1e-2)),
        "sgd_nesterov": lambda: o.sgd(o.warmup_cosine(1e-2, 1, 10),
                                      nesterov=True),
    }[name]()


OPTIMIZERS = ["adamw", "adamw_const", "adafactor", "sgd", "sgd_nesterov"]


def _two_updates(ns, opt, params, g, as_array, step_of):
    state = opt.init(params)
    for step, scale in ((0, 1.0), (1, 0.5)):
        gs = ns(lambda x: as_array(x * scale), g)
        params, state = opt.update(gs, state, params, step_of(step))
    return params, state


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_optimizer_updates_equal_reference(reference, name):
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    s = _setup(reference)
    ropt, popt = _opts(reference, name), _opts(optim, name)
    rp, rs = _two_updates(
        jax.tree.map, ropt, jax.tree.map(jnp.asarray, s["arrays"]), s["g"],
        jnp.asarray, lambda i: jnp.asarray(i, jnp.int32))
    pp, ps = _two_updates(
        map_trees, popt, lm_params_from_arrays(s["arrays"], CFG,
                                               device="cpu"),
        map_trees(torch.from_numpy, s["g"]), lambda x: x,
        lambda i: torch.tensor(i, dtype=torch.int32))
    _close_tree(pp, jax.tree.map(np.asarray, rp), **OPT_TOL)
    _close_tree(ps, jax.tree.map(np.asarray, rs), **OPT_TOL)
    if name == "adafactor":        # the factored branch ran
        assert "vr" in ps["stats"]["dense_layers"]["w_gate"]
        assert "v" in ps["stats"]["final_norm"]


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_optimizer_updates_on_bf16_params(reference, name):
    """A bf16 copy of the params and gradients: the new params land on
    the reference's bf16 values bit for bit but for rounding ties of the
    fp32 update (at most 0.1 %, one ulp apart)."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    s = _setup(reference)
    ropt, popt = _opts(reference, name), _opts(optim, name)
    r16 = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), s["arrays"])
    rp, _ = _two_updates(
        jax.tree.map, ropt, r16, s["g"],
        lambda x: jnp.asarray(x, jnp.bfloat16),
        lambda i: jnp.asarray(i, jnp.int32))
    p16 = map_trees(lambda a: torch.from_numpy(a).to(torch.bfloat16),
                    s["arrays"])
    pp, _ = _two_updates(
        map_trees, popt, p16,
        map_trees(lambda a: torch.from_numpy(a).to(torch.bfloat16),
                  s["g"]), lambda x: x.to(torch.bfloat16),
        lambda i: torch.tensor(i, dtype=torch.int32))
    mine, theirs = _paths(pp), _paths(jax.tree.map(np.asarray, rp))
    n = same = 0
    for k in theirs:
        assert mine[k].dtype == torch.bfloat16, k
        a = mine[k].view(torch.int16).numpy().astype(np.int32)
        b = theirs[k].view(np.int16).astype(np.int32)
        assert np.abs(a - b).max() <= 1, k
        n += a.size
        same += int((a == b).sum())
    assert same >= 0.999 * n, (same, n)


def test_schedules_and_norms_equal_reference(reference):
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    ro, s = reference.optim, _setup(reference)
    steps = [0, 1, 5, 19, 20, 21, 60, 99, 100, 140]
    for r, p in ((ro.warmup_cosine(3e-4, 20, 100),
                  optim.warmup_cosine(3e-4, 20, 100)),
                 (ro.warmup_cosine(1e-3, 0, 50, floor=0.2),
                  optim.warmup_cosine(1e-3, 0, 50, floor=0.2)),
                 (ro.constant_lr(0.5), optim.constant_lr(0.5))):
        for st in steps:
            a = p(torch.tensor(st, dtype=torch.int32))
            b = np.asarray(r(jnp.asarray(st, jnp.int32)))
            assert a.dtype == torch.float32 and a.shape == ()
            np.testing.assert_array_max_ulp(a.numpy(), b, maxulp=1)
    g = map_trees(torch.from_numpy, s["g"])
    rg = s["g"]
    np.testing.assert_allclose(_np(optim.global_norm(g)),
                               np.asarray(ro.global_norm(rg)), rtol=1e-6)
    for max_norm in (1e-3, 1.0, 1e3):
        pc, pn = optim.clip_by_norm(g, max_norm)
        rc, rn = ro.clip_by_norm(rg, max_norm)
        np.testing.assert_allclose(_np(pn), np.asarray(rn), rtol=1e-6)
        _close_tree(pc, jax.tree.map(np.asarray, rc), 1e-6)


def test_state_specs_equal_reference(reference):
    from repro_torch.distributed.sharding import SINGLE_POD_PLAN

    R, ro = reference.transformer, reference.optim
    rplan = reference.sharding.SINGLE_POD_PLAN
    rcfg = reference.configs_base.LMConfig(**CFG_KW)
    for name in ("adamw", "sgd", "adafactor"):
        ropt, popt = _opts(reference, name), _opts(optim, name)
        rs = ro.state_specs(ropt, R.param_specs(rcfg, rplan),
                            R.param_shapes(rcfg, rplan))
        ps = optim.state_specs(popt, PT.param_specs(CFG, SINGLE_POD_PLAN),
                               PT.param_shapes(CFG))
        mine, theirs = _paths(ps), _flat_specs(rs)
        assert mine.keys() == theirs.keys()
        for k in theirs:
            assert _spec(mine[k]) == theirs[k], k


def _flat_specs(tree, prefix=""):
    from jax.sharding import PartitionSpec as P

    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat_specs(tree[k], f"{prefix}/{k}"))
        return out
    assert tree is None or isinstance(tree, P), (prefix, tree)
    return {prefix: _spec(tuple(tree) if tree is not None else ())}


def _spec(entries) -> tuple:
    """A spec as a tuple of axis tuples, trailing Nones dropped."""
    out = [tuple(e) if isinstance(e, (tuple, list)) else
           ((e,) if e is not None else None) for e in entries]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def test_int8_quantization_equals_reference(reference):
    jnp = pytest.importorskip("jax.numpy")
    rc = reference.compression
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((16, 8, 4)) * 10).astype(np.float32)
    x[0, 0, 0] = 0.5 * (x.max() / 127.0)         # a rounding tie region
    for axis in (None, 0, (1, 2), -1):
        q, s = quantize_int8(torch.from_numpy(x), axis=axis)
        rq, rs = rc.quantize_int8(jnp.asarray(x), axis=axis)
        assert q.dtype == torch.int8
        assert np.array_equal(q.numpy(), np.asarray(rq)), axis
        np.testing.assert_array_max_ulp(s.numpy(), np.asarray(rs), maxulp=1)
        np.testing.assert_allclose(
            dequantize_int8(q, s).numpy(),
            np.asarray(rc.dequantize_int8(rq, rs)), rtol=1e-6)


def test_error_feedback_equals_reference(reference):
    jnp = pytest.importorskip("jax.numpy")
    jax = pytest.importorskip("jax")
    rinit, rapply = reference.compression.make_ef_transform()
    pinit, papply = make_ef_transform()
    rng = np.random.default_rng(4)
    gs = [{"w": rng.standard_normal((8, 6)).astype(np.float32) * 1e-3,
           "b": rng.standard_normal((6,)).astype(np.float32)}
          for _ in range(5)]
    rbuf = rinit(jax.tree.map(jnp.asarray, gs[0]))
    pbuf = pinit(map_trees(torch.from_numpy, gs[0]))
    for g in gs:
        rout, rbuf = rapply(jax.tree.map(jnp.asarray, g), rbuf)
        pout, pbuf = papply(map_trees(torch.from_numpy, g), pbuf)
        _close_tree(pout, jax.tree.map(np.asarray, rout), 1e-6, 1e-7)
        _close_tree(pbuf, jax.tree.map(np.asarray, rbuf), 1e-5, 1e-6)


STEP_CASES = {"plain": dict(), "accum2": dict(accum=2),
              "compress": dict(compress=True)}


def _ref_state_arrays(jax, state) -> dict:
    return {"step": np.asarray(state.step),
            "params": jax.tree.map(np.asarray, state.params),
            "opt_state": jax.tree.map(np.asarray, state.opt_state),
            "ef_buf": None if state.ef_buf is None else
            jax.tree.map(np.asarray, state.ef_buf)}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_step_equals_reference(reference, case):
    """One step from the same train state (the reference's after three
    steps, converted with ``train_state_from_arrays``: AdamW's m and v
    carry history, so no entry's update rests on one step's rounding of a
    near-zero gradient) on the same batch, at the fp32 compute policy
    (logic apart from bf16 rounding): new params, m and v, the EF buffer
    and the aux values."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    s = _setup(reference)
    kw = STEP_CASES[case]
    rl, T = reference.loop, reference.transformer
    ropt, popt = _opts(reference, "adamw_const"), _opts(optim, "adamw_const")
    rstate = _trained_ref_state(reference, jax,
                                compress=kw.get("compress", False))
    pstate = train_state_from_arrays(_ref_state_arrays(jax, rstate), CFG,
                                     popt, device="cpu")
    batch = STREAM.batch_at(3)
    if kw.get("accum"):
        batch = {k: v.reshape(2, 2, *v.shape[1:]) for k, v in batch.items()}
    rstep = jax.jit(rl.make_train_step(
        lambda p, b: T.loss_fn(p, b, s["rcfg"]), ropt, **kw))
    T.set_precision(jnp.float32, jnp.float32)
    PT.set_precision(torch.float32, torch.float32)
    try:
        rnew, raux = rstep(rstate, batch)
        pnew, paux = make_train_step(_loss, popt, **kw)(pstate, batch)
    finally:
        T.set_precision()
        PT.set_precision()
    assert int(pnew.step) == int(rnew.step) == 4
    assert pnew.step.dtype == torch.int32
    assert set(paux) == set(raux)
    _close_tree(paux, jax.tree.map(np.asarray, raux), **_step_tol())
    tree = _ref_state_arrays(jax, rnew)
    # compressed: a gradient entry within the two packages' difference of
    # an int8 step boundary quantizes one step apart.  With gradients 2e-5
    # of the max apart and a step of 1/127 of a row's max, about
    # 2 * 2e-5 * 127 = 0.5 % of entries may (3 of 2,048 for w_q's m); at
    # most 1 % of a leaf's params, m and v entries do
    tol = dict(_step_tol(), flips=1e-2 if kw.get("compress") else 0.0)
    _close_tree(pnew.params, tree["params"], **tol)
    _close_tree(pnew.opt_state, tree["opt_state"], **tol)
    # (the EF buffer, the residual of those roundings, is held bit for bit
    # by test_compressed_step_on_exact_gradients)
    assert (pnew.ef_buf is None) == (not kw.get("compress"))


def test_compressed_step_on_exact_gradients(reference):
    """``compress=True`` on a loss whose gradient both packages compute
    exactly (``sum(w * p)`` over the leaves, w numpy-seeded), from the
    reference's trained state with its EF buffer: the int8 payloads
    agree, so the new buffer and the step's state agree to the optimizer
    tolerance."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    rng = np.random.default_rng(5)
    rstate = _trained_ref_state(reference, jax, compress=True)
    w = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        np.float32), jax.tree.map(np.asarray, rstate.params))

    def rloss(p, b):
        tot = sum(jnp.sum(jnp.asarray(a) * x) for a, x in
                  zip(jax.tree.leaves(w), jax.tree.leaves(p)))
        return tot, {"loss": tot}

    def ploss(p, b):
        tot = sum(torch.sum(torch.from_numpy(a) * x) for a, x in
                  zip(leaves(w), leaves(p)))
        return tot, {"loss": tot}

    ropt, popt = _opts(reference, "adamw_const"), _opts(optim, "adamw_const")
    pstate = train_state_from_arrays(_ref_state_arrays(jax, rstate), CFG,
                                     popt, device="cpu")
    rnew, raux = reference.loop.make_train_step(
        rloss, ropt, compress=True)(rstate, None)
    pnew, paux = make_train_step(ploss, popt, compress=True)(pstate, None)
    tree = _ref_state_arrays(jax, rnew)
    for part in ("params", "opt_state", "ef_buf"):
        _close_tree(getattr(pnew, part), tree[part], **OPT_TOL)
    _close_tree(paux, jax.tree.map(np.asarray, raux), **OPT_TOL)


def _step_tol():
    return dict(rtol=STEP_TOL["rtol"], atol_of_max=STEP_TOL["atol"])


def test_train_state_from_arrays_checks_leaves(reference):
    s = _setup(reference)
    popt = _opts(optim, "adamw")
    good = {"step": np.int32(3), "params": s["arrays"],
            "opt_state": {"m": s["arrays"], "v": s["arrays"]}}
    st = train_state_from_arrays(good, CFG, popt, device="cpu")
    assert int(st.step) == 3 and st.ef_buf is None
    assert st.opt_state["m"]["embed"].dtype == torch.float32
    bad = dict(good, opt_state={"m": s["arrays"]})
    with pytest.raises(ValueError, match="keys"):
        train_state_from_arrays(bad, CFG, popt, device="cpu")
    short = dict(good, ef_buf={**s["arrays"],
                               "embed": s["arrays"]["embed"][:-1]})
    with pytest.raises(ValueError, match="embed"):
        train_state_from_arrays(short, CFG, popt, device="cpu")


# ---------------------------------------------------------------------------
# checkpoints across the two packages
# ---------------------------------------------------------------------------


def test_checkpoint_leaf_names_equal_reference(reference, tmp_path):
    """A TrainState's leaves get the reference's names: ``0`` (the step),
    ``1__<param path>``, ``2__m__...`` / ``2__v__...`` and nothing for a
    missing EF buffer (37 leaves for this config under AdamW)."""
    jax = pytest.importorskip("jax")
    s = _setup(reference)
    ropt, popt = _opts(reference, "adamw"), _opts(optim, "adamw")
    rstate = reference.loop.init_state(
        jax.tree.map(jax.numpy.asarray, s["arrays"]), ropt)
    reference.checkpoint.save(str(tmp_path / "ref"), 1, rstate)
    pstate = init_state(lm_params_from_arrays(s["arrays"], CFG,
                                              device="cpu"), popt)
    C.save(str(tmp_path / "port"), 1, pstate)

    def manifest(d):
        with open(os.path.join(d, "step_00000001", "manifest.json")) as f:
            return json.load(f)["leaves"]

    r, p = manifest(tmp_path / "ref"), manifest(tmp_path / "port")
    assert sorted(p) == sorted(r) and len(p) == 37
    assert "0" in p and "1__dense_layers__ln1" in p and "1__embed" in p
    assert "2__m__final_norm" in p and "2__v__dense_layers__w_q" in p
    assert [n for n, _ in C.leaf_paths(pstate)] == \
        [n for n, _ in reference.checkpoint._leaf_paths(rstate)]
    for k in r:
        assert (p[k]["shape"], p[k]["dtype"]) == (r[k]["shape"],
                                                  r[k]["dtype"]), k


def _trained_ref_state(reference, jax, steps=3, compress=False):
    s = _setup(reference)
    ropt = _opts(reference, "adamw_const")
    rl, T = reference.loop, reference.transformer
    st = rl.init_state(jax.tree.map(jax.numpy.asarray, s["arrays"]), ropt,
                       compress=compress)
    step = jax.jit(rl.make_train_step(
        lambda p, b: T.loss_fn(p, b, s["rcfg"]), ropt, compress=compress))
    for i in range(steps):
        st, _ = step(st, STREAM.batch_at(i))
    return st


@pytest.mark.parametrize("compress", [False, True])
def test_checkpoint_reference_to_port_bit_for_bit(reference, tmp_path,
                                                   compress, arrays):
    jax = pytest.importorskip("jax")
    rstate = _trained_ref_state(reference, jax, compress=compress)
    reference.checkpoint.save(str(tmp_path), 3, rstate)
    popt = _opts(optim, "adamw_const")
    template = init_state(_init(arrays), popt, compress=compress)
    got = C.restore(str(tmp_path), C.latest_step(str(tmp_path)), template)
    assert isinstance(got, TrainState)
    want = _ref_state_arrays(jax, rstate)
    assert got.step.dtype == torch.int32 and got.step.shape == ()
    assert int(got.step) == 3
    for part in ("params", "opt_state", "ef_buf"):
        if want[part] is None:
            assert getattr(got, part) is None
            continue
        mine, theirs = _paths(getattr(got, part)), _paths(want[part])
        assert mine.keys() == theirs.keys()
        for k in theirs:
            assert mine[k].dtype == torch.float32
            assert np.array_equal(mine[k].numpy(), theirs[k]), k


def test_checkpoint_port_to_reference_bit_for_bit(reference, tmp_path,
                                                   arrays):
    jax = pytest.importorskip("jax")
    popt = _opts(optim, "adamw_const")
    st = init_state(_init(arrays), popt)
    step = make_train_step(_loss, popt)
    for i in range(3):
        st, _ = step(st, STREAM.batch_at(i))
    C.save(str(tmp_path), 3, st, meta={"note": "port"})
    s = _setup(reference)
    ropt = _opts(reference, "adamw_const")
    template = reference.loop.init_state(
        jax.tree.map(jax.numpy.asarray, s["arrays"]), ropt)
    assert reference.checkpoint.latest_step(str(tmp_path)) == 3
    got = reference.checkpoint.restore(str(tmp_path), 3, template)
    assert int(got.step) == 3
    for part in ("params", "opt_state"):
        mine = _paths(getattr(st, part))
        theirs = _paths(jax.tree.map(np.asarray, getattr(got, part)))
        assert mine.keys() == theirs.keys()
        for k in theirs:
            assert np.array_equal(mine[k].numpy(), theirs[k]), k


def test_checkpoint_bf16_leaves_round_trip(tmp_path):
    """bf16 leaves are stored as the reference stores them (raw ``V2``
    elements under ``bfloat16``) and restored bit for bit."""
    t = {"a": torch.randn(5, 3).to(torch.bfloat16), "b": torch.arange(4)}
    C.save(str(tmp_path), 1, t)
    with open(tmp_path / "step_00000001" / "manifest.json") as f:
        man = json.load(f)["leaves"]
    assert man["a"]["dtype"] == "bfloat16" and man["b"]["dtype"] == "int64"
    assert np.load(tmp_path / "step_00000001" / "a.npy").dtype == \
        np.dtype("V2")
    got = C.restore(str(tmp_path), 1, t)
    assert got["a"].dtype == torch.bfloat16
    assert torch.equal(got["a"].view(torch.int16), t["a"].view(torch.int16))
    assert torch.equal(got["b"], t["b"])


# ---------------------------------------------------------------------------
# the reference's own behaviours, on the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor", "sgd"])
def test_optimizers_reduce_loss(opt_name, arrays):
    opt = {
        "adamw": optim.adamw(optim.constant_lr(1e-3)),
        "adafactor": optim.adafactor(optim.constant_lr(1e-2),
                                     min_dim_factored=16),
        "sgd": optim.sgd(optim.constant_lr(1e-2)),
    }[opt_name]
    state = init_state(_init(arrays), opt)
    res = train(state, make_train_step(_loss, opt), STREAM.batch_at, 25,
                log_every=8)
    assert res.history[-1]["loss"] < res.history[0]["loss"]
    assert [h["step"] for h in res.history] == [0, 8, 16, 24]


def test_grad_accumulation_matches_big_batch(arrays):
    opt = optim.sgd(optim.constant_lr(1e-2), momentum=0.0)
    big = STREAM.batch_at(0)
    micro = {k: v.reshape(2, 2, *v.shape[1:]) for k, v in big.items()}
    s1, _ = make_train_step(_loss, opt)(init_state(_init(arrays), opt),
                                        big)
    s2, _ = make_train_step(_loss, opt, accum=2)(
        init_state(_init(arrays), opt), micro)
    for a, b in zip(leaves(s1.params), leaves(s2.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4,
                                   atol=2e-5)


def test_int8_quantization_bounds_error():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(64, 64)).astype(np.float32))
    q, s = quantize_int8(x)
    err = float((dequantize_int8(q, s) - x).abs().max())
    assert err <= float(s) * 0.5 + 1e-7


def test_error_feedback_carries_residual():
    init, apply = make_ef_transform()
    g = {"w": torch.full((8, 8), 0.003)}
    buf = init(g)
    total = torch.zeros((8, 8))
    for _ in range(30):
        out, buf = apply(g, buf)
        total += out["w"]
    np.testing.assert_allclose((total / 30).numpy(), 0.003, rtol=0.05)


def test_compressed_training_parity(arrays):
    opt = optim.adamw(optim.constant_lr(1e-3))
    plain = train(init_state(_init(arrays), opt), make_train_step(_loss, opt),
                  STREAM.batch_at, 25, log_every=24)
    comp = train(init_state(_init(arrays), opt, compress=True),
                 make_train_step(_loss, opt, compress=True),
                 STREAM.batch_at, 25, log_every=24)
    assert abs(plain.history[-1]["loss"] - comp.history[-1]["loss"]) < 0.1


def _same_params(a: TrainState, b: TrainState) -> None:
    for x, y in zip(leaves(a.params), leaves(b.params)):
        assert torch.equal(x, y)


def test_checkpoint_restart_bit_identical(tmp_path, arrays):
    opt = optim.adamw(optim.constant_lr(1e-3))
    step = make_train_step(_loss, opt)
    d = str(tmp_path)
    full = train(init_state(_init(arrays), opt), step, STREAM.batch_at, 14,
                 ckpt_dir=d, ckpt_every=7, ckpt_async=False)
    assert C.latest_step(d) == 14
    resumed = train(C.restore(d, 7, init_state(_init(arrays), opt)), step,
                    STREAM.batch_at, 14)
    _same_params(full.state, resumed.state)


def test_async_save_of_the_last_step_and_the_final_save(tmp_path):
    """The last step is a checkpoint step: its async save and the final
    save write the same step; ``train`` lets the first finish, so both
    commit (the reference's loop starts the second at once and the two
    writers race on ``step_<N>.tmp``)."""
    opt = optim.sgd(optim.constant_lr(1e-2))
    d = str(tmp_path)
    params = {"w": torch.ones(512, 512), "b": torch.zeros(512)}

    def loss(p, b):
        out = ((p["w"] @ p["w"]).sum() + p["b"].sum()) * 1e-6
        return out, {"loss": out}

    res = train(init_state(params, opt), make_train_step(loss, opt),
                lambda i: None, 4, ckpt_dir=d, ckpt_every=2)
    assert C.latest_step(d) == 4
    got = C.restore(d, 4, res.state)
    assert torch.equal(got.params["w"], res.state.params["w"])
    assert not [f for f in os.listdir(d) if f.endswith(".tmp")]


def test_checkpoint_crc_detects_corruption(tmp_path, arrays):
    opt = optim.sgd(optim.constant_lr(1e-2))
    d = str(tmp_path)
    state = init_state(_init(arrays), opt)
    C.save(d, 5, state)
    target = next(os.path.join(d, "step_00000005", f)
                  for f in sorted(os.listdir(os.path.join(
                      d, "step_00000005"))) if f.endswith(".npy"))
    with open(target, "r+b") as fh:
        fh.seek(100)
        fh.write(b"\xde\xad")
    with pytest.raises(IOError):
        C.restore(d, 5, state)


def test_fault_injection_restart_recovers(tmp_path, arrays):
    """Crash at step 9 -> the supervisor restarts from the checkpoint ->
    the final params equal an uninterrupted run's bit for bit."""
    opt = optim.adamw(optim.constant_lr(1e-3))
    step = make_train_step(_loss, opt)
    d = str(tmp_path)
    baseline = train(init_state(_init(arrays), opt), step, STREAM.batch_at, 16)
    inject = make_fault_injector({9})

    def run(resume):
        state = init_state(_init(arrays), opt)
        if resume is not None:
            state = C.restore(d, C.latest_step(d), state)
        return train(state, step, STREAM.batch_at, 16, ckpt_dir=d,
                     ckpt_every=4, ckpt_async=False, fault_injector=inject)

    result, restarts = run_with_restart(run, max_restarts=2)
    assert restarts == 1
    _same_params(baseline.state, result.state)
    with pytest.raises(FaultInjected):
        run_with_restart(lambda r: make_fault_injector({0}, once=False)(0),
                         max_restarts=1)


def test_watchdog_flags_stragglers():
    wd = Watchdog(factor=3.0, warmup=3)
    for i in range(20):
        wd.observe(i, 0.01 if i != 15 else 0.2)
    assert wd.straggler_steps == [15]


def test_save_async_snapshots_before_it_returns(tmp_path):
    """The host copy is taken at the call: an in-place update right after
    it (as the sparse step makes) does not reach the checkpoint."""
    t = {"w": torch.arange(6, dtype=torch.float32)}
    C.save_async(str(tmp_path), 1, t)
    t["w"].add_(100.0)
    C.wait_pending()
    got = C.restore(str(tmp_path), 1, t)
    assert torch.equal(got["w"], torch.arange(6, dtype=torch.float32))


def test_latest_step_ignores_uncommitted_and_gc_keeps_last(tmp_path):
    d = str(tmp_path)
    t = {"w": torch.zeros(2)}
    assert C.latest_step(d) is None
    for s in (1, 2, 3, 4):
        C.save(d, s, t, keep_last=2)
    assert sorted(os.listdir(d)) == ["step_00000003", "step_00000004"]
    os.makedirs(os.path.join(d, "step_00000009.tmp"))
    os.makedirs(os.path.join(d, "step_00000008"))     # no COMMITTED
    assert C.latest_step(d) == 4
    with pytest.raises(ValueError, match="shape mismatch"):
        C.restore(d, 4, {"w": torch.zeros(3)})


def test_restore_places_leaves_on_the_template_device(tmp_path):
    t = {"w": torch.ones(3), "n": {"s": torch.tensor(2, dtype=torch.int32)}}
    C.save(str(tmp_path), 1, t)
    meta = {"w": torch.empty(3, device="meta"),
            "n": {"s": torch.empty((), dtype=torch.int32, device="meta")}}
    got = C.restore(str(tmp_path), 1, meta)
    assert got["w"].device.type == "meta" and got["n"]["s"].dtype == \
        torch.int32
    assert got["n"]["s"].shape == ()            # a scalar stays 0-d


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor", "sgd"])
def test_update_keeps_its_inputs_and_the_step_consumes_the_state(opt_name):
    """One in-place rule a leaf: ``opt.update`` runs it on copies (the
    inputs kept, as the reference's update) and the train step on the
    state itself (as the reference's donated step), to the same values;
    a broadcast gradient (no storage of its own) is taken as any other."""
    opt = {"adamw": optim.adamw(optim.constant_lr(1e-2)),
           "adafactor": optim.adafactor(optim.constant_lr(1e-2),
                                        min_dim_factored=4),
           "sgd": optim.sgd(optim.constant_lr(1e-2))}[opt_name]
    gen = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(8, 6, generator=gen),
              "b": torch.randn(6, generator=gen)}
    grads = {"w": torch.randn(8, 6, generator=gen),
             "b": torch.ones(()).expand(6)}
    state = opt.init(params)
    def flat(*trees):
        return [x for t in trees for x in leaves(t)]

    before = [x.clone() for x in flat(params, state, grads)]
    new_p, new_s = opt.update(grads, state, params, torch.tensor(3))
    for x, y in zip(flat(params, state, grads), before, strict=True):
        assert torch.equal(x, y)
    assert not torch.equal(new_p["w"], params["w"])

    def loss(p, b):
        out = (p["w"] * grads["w"]).sum() + (p["b"] * grads["b"]).sum()
        return out, {"loss": out}

    st = TrainState(step=torch.tensor(3, dtype=torch.int32), params=params,
                    opt_state=state)
    got, aux = make_train_step(loss, opt, grad_clip=1e9)(st, None)
    assert got.params["w"] is params["w"]
    for x, y in zip(flat(got.params, got.opt_state), flat(new_p, new_s),
                    strict=True):
        assert torch.equal(x, y)
    np.testing.assert_allclose(float(aux["grad_norm"]), float(
        optim.global_norm(grads)), rtol=1e-6)
