"""Port vs reference: training — the flash-attention backward, whole-model
gradients, the train step, microbatching, the trainer with pruning, resume,
preemption, the quickstart flow and the launcher.

Both packages start from one numpy init (the port's ``init_params``,
carried across with ``convert``; ``jax.random`` init cannot be reproduced
in torch) and read one ``SyntheticDataset`` stream, byte-identical in both.
The reference's ``Trainer`` is subclassed here to start from that init and
built on an Auto-axis mesh (ROADMAP.md C1).

Tolerances, and why:
  * The flash-attention backward takes P, dS, dO, Q and K into its products
    rounded to bf16, at the reference's rounding points, so it agrees with
    the reference's custom VJP far below bf16's step: dq, dk and dv within
    1e-4 of their largest value (measured: at most 1.9e-7 at s = 32, 2.7e-5
    at s = 520, where a few bf16 roundings flip on fp32 inputs that differ
    by an ulp), and dx through the attention block within 1e-4 at s = 32
    (measured 1.3e-6; 1e-3 at s = 520, measured 4.0e-4,
    ``test_attention_dx_matches_reference``).  Plain
    autograd through the prefill attend rounds elsewhere and misses by
    3e-3 or more, which the s = 32 case asserts.
  * Whole-model grads in fp32: every leaf within 5e-3 of its largest |grad|
    (measured: at most 2.2e-3, ``llama3_2_1b``'s w_up; those same bf16
    flips, carried through the layers).
  * The train step in lockstep (each of 5 steps from the reference's state,
    carried across): loss within rtol 1e-4 and gnorm within rtol 1e-3
    (measured: at most 4.9e-6 and 3.8e-4), and the weights after each step
    as ``_params_close`` says.  Run free, the two part further step by
    step, because Adam's first updates are about ``lr * sign(g)``: a bf16
    flip that moves a tiny gradient across zero moves its weight by 2 lr,
    and gnorm then leaves 1e-3.  So the trainer comparison holds the logged
    losses to 5e-3 relative over 10 steps (measured 1.6e-3) and both
    sparsities to 0.85 +- 0.02.
  * Within the port, resume, preemption and remat are bitwise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke
from repro.models import build_model as ref_build
from repro.models import layers as ref_layers
from repro.optim import AdamState as RefAdamState
from repro.optim import adamw_init as ref_adamw_init
from repro.train import TrainConfig as RefTrainConfig
from repro.train import Trainer as RefTrainer
from repro.train import TrainHParams as RefHParams
from repro.train.step import make_train_step as ref_make_train_step
from repro_torch.configs import get_smoke_config
from repro_torch.convert import (
    adam_state_from_numpy, adam_state_to_numpy, params_from_numpy, params_to_numpy,
)
from repro_torch.core.pruning import tree_sparsity
from repro_torch.data import SyntheticDataset
from repro_torch.launch import train as train_launcher
from repro_torch.models import build_model, layers
from repro_torch.optim import adamw_init
from repro_torch.optim.adamw import tree_items
from repro_torch.serve import Engine, ServeConfig
from repro_torch.train import TrainConfig, Trainer, TrainHParams, make_train_step

ARCHS = ["vusa_edge", "llama3_2_1b"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: one intra-op thread runs them faster than many and
    leaves the cores to the test workers beside this one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want) -> float:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) / float(np.abs(want).max())


def _jnp_tree(tree):
    return jax.tree_util.tree_map(lambda a: jnp.array(np.array(a, copy=True)), tree)


def _pairs(ref_tree, port_tree):
    """(path, reference leaf, port leaf) over the reference tree's leaves."""
    for path, leaf in jax.tree_util.tree_flatten_with_path(ref_tree)[0]:
        node = port_tree
        for k in path:
            node = node[k.key]
        yield "/".join(k.key for k in path), np.asarray(leaf), node


def _init(arch):
    return params_to_numpy(build_model(get_smoke_config(arch)).init(0, device="cpu"))


# ---------------------------------------------------------------------------
# (a) the flash-attention backward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s", [32, 520])  # one chunk; 520 pads to two chunks of 512
def test_flash_backward_matches_reference_vjp(s):
    rng = np.random.default_rng(s)
    b, kvh, g, hd = 2, 2, 2, 8
    q = rng.standard_normal((b, s, kvh, g, hd), dtype=np.float32)
    k, v = (rng.standard_normal((b, s, kvh, hd), dtype=np.float32) for _ in range(2))
    dout = rng.standard_normal(q.shape, dtype=np.float32)
    chunk = min(512, s)
    pad = (-s) % chunk

    def ref(q, k, v):
        p5, p4 = ((0, 0), (0, pad), (0, 0), (0, 0), (0, 0)), ((0, 0), (0, pad), (0, 0), (0, 0))
        pos = jnp.pad(jnp.arange(s), (0, pad))
        valid = jnp.pad(jnp.ones((s,), bool), (0, pad))
        flash = ref_layers._make_flash_vjp(ref_layers.MaskSpec("causal"), chunk, chunk)
        return flash(jnp.pad(q, p5), jnp.pad(k, p4), jnp.pad(v, p4), pos, pos, valid)[:, :s]

    want_out, vjp = jax.vjp(ref, q, k, v)
    want = vjp(dout)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = layers.flash_attention_train(tq, tk, tv, torch.arange(s))
    out.backward(torch.from_numpy(dout))
    assert _rel(out, want_out) <= 1e-4
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        assert _rel(got, w) <= 1e-4
    if s == 32:  # the witness: plain autograd through the prefill attend
        pq, pk, pv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
        pos = torch.arange(s)
        layers._flash_attend(pq, pk, pv, layers.MaskSpec("causal"), pos, pos).backward(
            torch.from_numpy(dout))
        assert min(_rel(got, w) for got, w in zip((pq.grad, pk.grad, pv.grad), want)) > 1e-3


@pytest.mark.parametrize("s,tol", [(32, 1e-4), (520, 1e-3)])
def test_attention_dx_matches_reference(s, tol):
    """dx and the projection grads through the whole attention block.  At
    s = 520 (two padded chunks, 520 x 520 scores) more bf16 roundings flip
    between the packages, on dO and Q/K from the projections as well:
    measured dx 4.0e-4 of its largest value, 3.6e-6 with the bf16 roundings
    taken out of both packages, so the padded path itself is exact."""
    cfg = get_smoke_config("llama3_2_1b")  # GQA: 4 heads over 2 KV heads
    lp = {k: v[0] for k, v in _init("llama3_2_1b")["layers"]["attn"].items()}
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, s, cfg.d_model), dtype=np.float32)
    dy = rng.standard_normal(x.shape, dtype=np.float32)

    def ref(p, x):
        return ref_layers.attention(p, x, ref_smoke("llama3_2_1b"), ref_layers.MaskSpec("causal"))

    _, vjp = jax.vjp(ref, _jnp_tree(lp), jnp.asarray(x))
    want_p, want_x = vjp(jnp.asarray(dy))
    tp = {k: torch.from_numpy(v.copy()).requires_grad_() for k, v in lp.items()}
    tx = torch.from_numpy(x).requires_grad_()
    layers.attention(tp, tx, cfg, layers.MaskSpec("causal")).backward(torch.from_numpy(dy))
    assert _rel(tx.grad, want_x) <= tol
    for name, w in want_p.items():
        assert _rel(tp[name].grad, w) <= tol, name


def test_prefill_attend_is_unchanged_without_grad():
    """Without grad (serving) ``attention`` takes the prefill attend, bitwise
    the same function as before the training path existed."""
    cfg = get_smoke_config("vusa_edge")
    lp = params_from_numpy({k: v[0] for k, v in _init("vusa_edge")["layers"]["attn"].items()},
                           "cpu")
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 24, cfg.d_model),
                                                                  dtype=np.float32))
    with torch.no_grad():
        y = layers.attention(lp, x, cfg, layers.MaskSpec("causal"))
        q, k, v = layers._project_qkv(lp, x, cfg, torch.arange(24))
        q = q.reshape(2, 24, cfg.kv_heads, cfg.n_heads // cfg.kv_heads, cfg.hd)
        o = layers._flash_attend(q, k, v, layers.MaskSpec("causal"), torch.arange(24),
                                 torch.arange(24)).reshape(2, 24, cfg.n_heads, cfg.hd)
        want = torch.einsum("bsnh,nhd->bsd", o, lp["wo"])
    assert torch.equal(y, want)


# ---------------------------------------------------------------------------
# (b) whole-model gradients; remat
# ---------------------------------------------------------------------------


def _port_grads(arch, tokens, cfg=None):
    cfg = cfg or get_smoke_config(arch)
    params = params_from_numpy(_init(arch), "cpu")
    for _, leaf in tree_items(params):
        leaf.requires_grad_(True)
    loss = build_model(cfg).loss(params, {"tokens": torch.from_numpy(tokens)})
    loss.backward()
    return float(loss.detach()), {"/".join(p): leaf.grad for p, leaf in tree_items(params)}


@pytest.mark.parametrize("arch", ARCHS)
def test_model_grads_match_reference(arch):
    cfg = get_smoke_config(arch)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (2, 32)).astype(np.int32)
    want_loss, want = jax.value_and_grad(ref_build(ref_smoke(arch)).loss)(
        _jnp_tree(_init(arch)), {"tokens": jnp.asarray(tokens)})
    loss, grads = _port_grads(arch, tokens)
    assert loss == pytest.approx(float(want_loss), rel=1e-6)
    for path, w, _ in _pairs(want, _init(arch)):
        assert _rel(grads[path], w) <= 5e-3, path


def test_remat_is_bitwise_the_plain_backward():
    cfg = get_smoke_config("vusa_edge")
    tokens = np.random.default_rng(3).integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    plain = _port_grads("vusa_edge", tokens)
    remat = _port_grads("vusa_edge", tokens, dataclasses.replace(cfg, remat=True))
    assert plain[0] == remat[0]
    assert all(torch.equal(plain[1][k], remat[1][k]) for k in plain[1])


def test_loss_masks_padding_ids():
    """Labels >= vocab (the padded vocabulary) do not count, as the
    reference's ``_xent``."""
    cfg = dataclasses.replace(get_smoke_config("vusa_edge"), vocab=500)  # padded to 512
    params = params_from_numpy(_init("vusa_edge"), "cpu")
    tokens = np.random.default_rng(4).integers(0, 500, (2, 16)).astype(np.int32)
    tokens[0, 5], tokens[1, 9] = 505, 511
    rcfg = dataclasses.replace(ref_smoke("vusa_edge"), vocab=500)
    want = ref_build(rcfg).loss(_jnp_tree(_init("vusa_edge")), {"tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        got = build_model(cfg).loss(params, {"tokens": torch.from_numpy(tokens)})
    assert float(got) == pytest.approx(float(want), rel=1e-6)


# ---------------------------------------------------------------------------
# (d) the train step; (e) microbatching
# ---------------------------------------------------------------------------


def _ref_step(arch, hp):
    return jax.jit(ref_make_train_step(ref_build(ref_smoke(arch)).loss, RefHParams(**hp)))


def _port_state(jp, jo):
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return params, adam_state_from_numpy(jax.tree_util.tree_map(np.asarray, jo), "cpu")


def _params_close(jp, tp, lr):
    """Every weight within 2 lr (a gradient sign that flips between the
    packages moves a weight by at most that in one Adam step) and all but
    0.1 % of them within 0.1 lr (measured: at most 0.028 %)."""
    far, n = 0, 0
    for _, w, got in _pairs(jp, params_to_numpy(tp)):
        d = np.abs(got - w)
        assert float(d.max()) <= 2 * lr
        far += int((d > 0.1 * lr).sum())
        n += d.size
    assert far <= 1e-3 * n, far / n


@pytest.mark.parametrize("token_range", [0, 256])  # the full vocabulary; the launcher's stream
def test_train_step_matches_reference_in_lockstep(token_range):
    arch, hp = "vusa_edge", dict(lr=1e-3, warmup=2, total_steps=5)
    ref_step = _ref_step(arch, hp)
    step = make_train_step(build_model(get_smoke_config(arch)).loss, TrainHParams(**hp))
    jp = _jnp_tree(_init(arch))
    jo = ref_adamw_init(jp)
    data = iter(SyntheticDataset(get_smoke_config(arch), 4, 32, token_range=token_range))
    for i in range(5):
        batch = next(data)
        tp, to = _port_state(jp, jo)
        jp, jo, want = ref_step(jp, jo, {"tokens": jnp.asarray(batch["tokens"])})
        tp, to, got = step(tp, to, {"tokens": torch.from_numpy(batch["tokens"])})
        assert float(got["loss"]) == pytest.approx(float(want["loss"]), rel=1e-4), i
        assert float(got["gnorm"]) == pytest.approx(float(want["gnorm"]), rel=1e-3), i
        assert got["lr"] == pytest.approx(float(want["lr"]), rel=1e-6), i
        assert int(to.step) == int(jo.step) == i + 1
        _params_close(jp, tp, hp["lr"])
    for name, tree in (("mu", to.mu), ("nu", to.nu)):
        for path, w, got in _pairs(getattr(jo, name), params_to_numpy(tree)):
            assert got.shape == w.shape and np.isfinite(got).all(), (name, path)


def test_microbatches_match_full_batch_and_reference():
    arch, lr = "llama3_2_1b", 1e-3
    cfg = get_smoke_config(arch)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (4, 32)).astype(np.int32)
    outs = {}
    for mb in (1, 2):
        params = params_from_numpy(_init(arch), "cpu")
        step = make_train_step(build_model(cfg).loss, TrainHParams(lr=lr, microbatches=mb))
        outs[mb] = step(params, adamw_init(params), {"tokens": torch.from_numpy(tokens)})
    # equal-size microbatches: the mean of means is the mean; grads agree
    assert float(outs[2][2]["loss"]) == pytest.approx(float(outs[1][2]["loss"]), rel=1e-5)
    d = max(float((a - b).abs().max()) for (_, a), (_, b) in
            zip(tree_items(outs[1][0]), tree_items(outs[2][0])))
    assert d < 5e-3, d
    jp = _jnp_tree(_init(arch))
    jp2, _, want = _ref_step(arch, dict(lr=lr, microbatches=2))(
        jp, ref_adamw_init(jp), {"tokens": jnp.asarray(tokens)})
    got = outs[2][2]
    assert float(got["loss"]) == pytest.approx(float(want["loss"]), rel=1e-4)
    assert float(got["gnorm"]) == pytest.approx(float(want["gnorm"]), rel=1e-3)
    _params_close(jp2, outs[2][0], lr)


# ---------------------------------------------------------------------------
# (h) the trainer against the reference's; (i) resume and preemption
# ---------------------------------------------------------------------------


def _tc(**kw):
    base = dict(steps=10, global_batch=4, seq_len=32, prune_begin=4, prune_end=8,
                prune_every=2, log_every=1, token_range=16,
                hp=TrainHParams(lr=1e-3, warmup=2, total_steps=10))
    base.update(kw)
    return TrainConfig(**base)


def test_trainer_matches_reference_trainer():
    arch = "vusa_edge"
    init = _init(arch)

    class Ref(RefTrainer):  # the shared numpy init instead of jax.random
        def init_state(self):
            params = jax.device_put(_jnp_tree(init), self.p_shard)
            return params, ref_adamw_init(params)

    kw = {f.name: getattr(_tc(), f.name) for f in dataclasses.fields(TrainConfig)
          if f.name != "hp"}
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    ref = Ref(ref_smoke(arch), RefTrainConfig(hp=RefHParams(lr=1e-3, warmup=2, total_steps=10),
                                              **kw), mesh=mesh)
    want = ref.train()
    port = Trainer(get_smoke_config(arch), _tc(), device="cpu")
    got = port.train()
    assert [r["step"] for r in port.metrics_log] == [r["step"] for r in ref.metrics_log]
    for a, b in zip(port.metrics_log, ref.metrics_log):
        assert a["loss"] == pytest.approx(b["loss"], rel=5e-3), a["step"]
        assert a["lr"] == pytest.approx(b["lr"], rel=1e-6)
    assert got["sparsity"] == pytest.approx(0.85, abs=0.02)
    assert want["sparsity"] == pytest.approx(0.85, abs=0.02)
    assert got["steps_run"] == want["steps_run"] == 10
    assert got["final_loss"] == pytest.approx(want["final_loss"], rel=5e-3)


def _state_bitwise(a, b):
    for (pa, x), (pb, y) in zip(tree_items({"p": a["params"], "mu": a["opt"].mu,
                                            "nu": a["opt"].nu}),
                                tree_items({"p": b["params"], "mu": b["opt"].mu,
                                            "nu": b["opt"].nu})):
        assert pa == pb and torch.equal(x, y), pa
    assert torch.equal(a["opt"].step, b["opt"].step)


def test_resume_and_preemption_are_bitwise(tmp_path):
    """Straight through 10 steps; 4 + restore + 6; and preempted after step
    3 (the flag a SIGTERM sets) + restore + the rest: equal bitwise, pruning
    on (the resume step, 4, refreshes the masks)."""
    cfg = get_smoke_config("llama3_2_1b")
    full = Trainer(cfg, _tc(), device="cpu").train()
    half = Trainer(cfg, _tc(steps=4, ckpt_dir=str(tmp_path / "a"), ckpt_every=4), device="cpu")
    assert half.train()["steps_run"] == 4
    resumed = Trainer(cfg, _tc(ckpt_dir=str(tmp_path / "a"), ckpt_every=100), device="cpu").train()
    assert resumed["steps_run"] == 6
    _state_bitwise(full, resumed)

    pre = Trainer(cfg, _tc(ckpt_dir=str(tmp_path / "b"), ckpt_every=100), device="cpu")
    inner = pre.step_fn

    def step_then_preempt(params, opt, batch):
        out = inner(params, opt, batch)
        if int(out[1].step) == 4:
            pre._preempted = True  # what the SIGTERM/SIGINT handler does
        return out

    pre.step_fn = step_then_preempt
    assert pre.train()["steps_run"] == 4
    after = Trainer(cfg, _tc(ckpt_dir=str(tmp_path / "b"), ckpt_every=100), device="cpu")
    out = after.train()
    assert out["steps_run"] == 6 and out["sparsity"] == tree_sparsity(full["params"])
    _state_bitwise(full, out)


def test_signal_handler_sets_the_flag_and_is_put_back():
    import signal
    import threading

    tr = Trainer(get_smoke_config("vusa_edge"), _tc(), device="cpu")
    before = signal.getsignal(signal.SIGTERM)
    previous = tr._install_signal_handlers()
    try:
        if threading.current_thread() is threading.main_thread():
            signal.getsignal(signal.SIGTERM)(signal.SIGTERM, None)
            assert tr._preempted
        else:
            assert previous == {}
    finally:
        for sig, h in previous.items():
            signal.signal(sig, h)
    assert signal.getsignal(signal.SIGTERM) == before


def test_trainer_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(get_smoke_config("vusa_edge"), _tc())


def test_data_stream_is_the_references():
    from repro.data import SyntheticDataset as RefDataset

    for tr in (0, 16):
        a = SyntheticDataset(get_smoke_config("vusa_edge"), 4, 16, seed=7, token_range=tr)
        b = RefDataset(ref_smoke("vusa_edge"), 4, 16, seed=7, token_range=tr)
        for x, y, _ in zip(iter(a.skip_to(5)), iter(b.skip_to(5)), range(3)):
            assert x["tokens"].tobytes() == y["tokens"].tobytes()
    assert SyntheticDataset(get_smoke_config("vusa_edge"), 4, 16, host_count=2).local_batch == 2


# ---------------------------------------------------------------------------
# (k) the quickstart flow; (l) the launcher
# ---------------------------------------------------------------------------


def test_quickstart_flow_train_pack_serve():
    """``examples/quickstart.py`` through the port: train smoke ``vusa_edge``
    to 85 %, pack the whole decode step, serve: packed greedy tokens equal
    dense greedy tokens."""
    cfg = get_smoke_config("vusa_edge")
    tc = TrainConfig(steps=20, global_batch=4, seq_len=32, prune_begin=6, prune_end=16,
                     prune_every=2, token_range=32, log_every=5,
                     hp=TrainHParams(lr=2e-3, warmup=2, total_steps=20))
    out = Trainer(cfg, tc, device="cpu").train()
    assert out["sparsity"] == pytest.approx(0.85, abs=0.02)
    prompts = np.ones((2, 8), np.int32)
    dense = Engine(cfg, out["params"], ServeConfig(max_len=64), device="cpu").generate(
        prompts, max_new=12)
    packed = Engine(cfg, out["params"], ServeConfig(max_len=64, packed_weights="all"),
                    device="cpu").generate(prompts, max_new=12)
    assert dense["finite"] and packed["finite"]
    np.testing.assert_array_equal(packed["tokens"], dense["tokens"])


def test_launcher_trains_on_cpu(tmp_path, capsys):
    out = train_launcher.main(["--arch", "vusa_edge", "--smoke", "--device", "cpu", "--steps",
                               "4", "--batch", "2", "--seq", "16", "--microbatches", "2",
                               "--grad-compress", "--ckpt", str(tmp_path)])
    assert np.isfinite(out["final_loss"]) and out["steps_run"] == 4
    assert "final loss" in capsys.readouterr().out
    with pytest.raises(SystemExit):  # a mesh names its collective backend (--dist-backend)
        train_launcher.main(["--arch", "vusa_edge", "--smoke", "--device", "cpu", "--data", "2"])


def test_reference_state_crosses_to_the_port_and_back():
    jp = _jnp_tree(_init("vusa_edge"))
    jo = ref_adamw_init(jp)
    jo = RefAdamState(step=jnp.int32(9), mu=jax.tree_util.tree_map(lambda a: a + 1, jo.mu),
                      nu=jo.nu)
    opt = adam_state_from_numpy(jax.tree_util.tree_map(np.asarray, jo), "cpu")
    assert opt.step.dtype == torch.int32 and int(opt.step) == 9
    back = adam_state_to_numpy(opt)
    for _, w, got in _pairs(jo.mu, back["mu"]):
        np.testing.assert_array_equal(got, w)
