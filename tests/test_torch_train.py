"""The port's training slice against the JAX package's, on the CPU.

The counterparts of the 12 tests of ``tests/test_train.py`` (and of
``tests/elastic_scenario.py`` on one device), then the slice module by
module: trees in ``jax.tree.flatten``'s order, gradients of all ten
architectures against ``jax.value_and_grad``, the three remat policies,
AdamW's ``apply``, the train step with and without accumulation, the
data pipeline, checkpoints across the two packages, the async saver's
snapshot, ``compressed_psum`` at world sizes 1 and 4, the runner's
replay after a fault, the entry point, and a CPU rehearsal of
``chip_smoke``'s training phase.

Weights come from the JAX ``LM.init`` through ``params_from_numpy`` and
the JAX side is compiled with ``xla_allow_excess_precision`` off
(``run_ref``, ``tests/torch_arch_parity.py``).  Tolerances are written in
each test: bit for bit where both packages compute the same integer or
copy the same bits (batches, checkpoints, ``compressed_psum``, replays);
float results within bounds set from their dtypes.
"""

import dataclasses
import multiprocessing
import socket
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.shard_map import shard_map  # noqa: E402
from jax.sharding import Mesh, PartitionSpec as P  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.models.model import LM as RefLM  # noqa: E402
from repro.train import checkpoint as ref_ckpt  # noqa: E402
from repro.train import compress as ref_compress  # noqa: E402
from repro.train import data as ref_data  # noqa: E402
from repro.train import optimizer as ref_opt  # noqa: E402
from repro.train import runner as ref_runner  # noqa: E402
from repro.train import step as ref_step  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import compress  # noqa: E402
from repro_torch.train import data as data_mod  # noqa: E402
from repro_torch.train import optimizer as opt_mod  # noqa: E402
from repro_torch.train.runner import (RunnerConfig, Trainer,  # noqa: E402
                                      elastic_remesh)
from repro_torch.train.step import (jit_train_step,  # noqa: E402
                                    make_train_step, value_and_grad)
from repro_torch.train.tree import (tree_flatten, tree_leaves,  # noqa
                                    tree_map, tree_unflatten)
from torch_arch_parity import run_ref, to_torch  # noqa: E402
import torch_train_dist  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

ARCHS = configs.list_archs()


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------
def _setup(arch="qwen2-0.5b", seed=0, **overrides):
    """(JAX model, JAX params, port model, port params) on the same
    weights, at the smoke config."""
    ref_cfg = dataclasses.replace(ref_configs.get_config(arch, smoke=True),
                                  **overrides)
    cfg = dataclasses.replace(configs.get_config(arch, smoke=True),
                              **overrides)
    ref_model = RefLM(ref_cfg)
    ref_params = jax.jit(ref_model.init)(jax.random.PRNGKey(seed))
    return ref_model, ref_params, LM(cfg, device="cpu"), to_torch(ref_params)


def _state_to_torch(state):
    """A JAX ``OptState`` as the port's CPU ``OptState``."""
    return opt_mod.opt_state_from_numpy(jax.tree.map(np.asarray, state),
                                        device="cpu")


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _bits(x):
    """The raw bits of a tensor or array (bf16 as uint16)."""
    if isinstance(x, torch.Tensor):
        ints = {1: torch.int8, 2: torch.int16, 4: torch.int32,
                8: torch.int64}[x.element_size()]
        return x.detach().view(ints).numpy()
    a = np.asarray(x)
    return a.view({1: np.int8, 2: np.int16, 4: np.int32,
                   8: np.int64}[a.dtype.itemsize])


def _bf16_step(x):
    """One bf16 step (unit in the last place) at each element of ``x``."""
    mag = np.maximum(np.abs(_f32(x)), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(mag)) - 7)


def _batch(cfg, rng, b=2, s=16):
    """The same batch for both packages: (JAX dict, port dict)."""
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    ref, port = {"tokens": jnp.asarray(toks)}, {"tokens":
                                                torch.from_numpy(toks)}
    if cfg.is_encdec:
        src = jnp.asarray(rng.normal(0, 1, (b, s, cfg.d_model)),
                          jnp.bfloat16)
        ref["src_embeds"], port["src_embeds"] = src, to_torch(src)
    return ref, port


def _recording(step_fn, log):
    """``step_fn`` that appends (opt step, loss) to ``log``."""
    def fn(p, o, b):
        s = int(o.step)
        p, o, m = step_fn(p, o, b)
        log.append((s, float(m["loss"])))
        return p, o, m
    return fn


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------------------
# trees in the JAX package's order
# ---------------------------------------------------------------------------
def test_tree_flatten_matches_jax_order():
    """Dict keys sorted, lists/tuples in order, NamedTuple fields in
    field order, ``None`` empty, python scalars leaves: the leaves of
    ``jax.tree.flatten`` one for one, and unflatten inverts flatten."""
    state = opt_mod.OptState(step=7, mu={"z": 1, "a": 2}, nu={"z": 3,
                                                               "a": 4})
    ref_state = ref_opt.OptState(step=7, mu={"z": 1, "a": 2},
                                 nu={"z": 3, "a": 4})
    tree = {"params": {"w": 10, "b": [11, None, (12, 13)]}, "opt": state,
            "data": {"step": 14, "seed": 15.5}, "empty": None}
    ref_tree = dict(tree, opt=ref_state)
    leaves, treedef = tree_flatten(tree)
    assert leaves == jax.tree.leaves(ref_tree)
    back = tree_unflatten(treedef, leaves)
    assert back == tree and isinstance(back["opt"], opt_mod.OptState)
    assert tree_leaves(tree_map(lambda x: x + 1, tree)) == \
        [x + 1 for x in leaves]
    assert str(treedef).startswith("PyTreeDef({'data': {'seed': *")
    with pytest.raises(ValueError, match="structures differ"):
        tree_map(lambda a, b: a, {"a": 1}, {"b": 1})


# ---------------------------------------------------------------------------
# tests/test_train.py, one for one
# ---------------------------------------------------------------------------
def test_optimizer_converges_quadratic():
    """150 AdamW steps on a quadratic in both packages: the port
    converges and its iterates stay within float32 rounding of the
    reference's (rtol 1e-5 at every step)."""
    ref_cfg = ref_opt.OptConfig(lr=0.1, warmup_steps=5, total_steps=200,
                                weight_decay=0.0)
    cfg = opt_mod.OptConfig(lr=0.1, warmup_steps=5, total_steps=200,
                            weight_decay=0.0)
    ref_params = {"w": jnp.asarray([3.0, -2.0])}
    params = {"w": torch.tensor([3.0, -2.0])}
    ref_state, state = ref_opt.init(ref_params, ref_cfg), opt_mod.init(
        params, cfg)
    ref_loss = lambda p: jnp.sum(jnp.square(p["w"] - 1.0))  # noqa: E731
    loss = lambda p: torch.sum(torch.square(p["w"] - 1.0))  # noqa: E731
    grad = value_and_grad(loss)
    for _ in range(150):
        g = jax.grad(ref_loss)(ref_params)
        ref_params, ref_state, _ = ref_opt.apply(ref_params, g, ref_state,
                                                 ref_cfg)
        params, state, _ = opt_mod.apply(params, grad(params)[1], state, cfg)
        np.testing.assert_allclose(params["w"].numpy(),
                                   np.asarray(ref_params["w"]), rtol=1e-5)
    assert float(loss(params)) < 1e-2


def test_data_pipeline_deterministic_and_shardable():
    """Pure in the step, different across steps, 2-host shards cover the
    global batch -- and every batch bit-identical to the reference's."""
    cfg = data_mod.DataConfig(seed=7, global_batch=8, seq_len=16, vocab=100)
    ref_cfg = ref_data.DataConfig(seed=7, global_batch=8, seq_len=16,
                                  vocab=100)
    p0 = data_mod.Pipeline(cfg, device="cpu")
    a = p0.batch(3)["tokens"]
    assert a.dtype == torch.int32
    np.testing.assert_array_equal(a.numpy(), p0.batch(3)["tokens"].numpy())
    assert (p0.batch(4)["tokens"] != a).any()
    h0 = data_mod.Pipeline(cfg, host_id=0, n_hosts=2, device="cpu")
    h1 = data_mod.Pipeline(cfg, host_id=1, n_hosts=2, device="cpu")
    np.testing.assert_array_equal(
        torch.cat([h0.batch(3)["tokens"], h1.batch(3)["tokens"]]).numpy(),
        a.numpy())
    for host, n in ((0, 1), (0, 2), (1, 2)):
        ref = ref_data.Pipeline(ref_cfg, host_id=host, n_hosts=n)
        port = data_mod.Pipeline(cfg, host_id=host, n_hosts=n, device="cpu")
        for step in (0, 3, 4, 1000):
            np.testing.assert_array_equal(
                port.batch(step)["tokens"].numpy(),
                np.asarray(ref.batch(step)["tokens"]))
    assert p0.state_dict(5) == ref_data.Pipeline(ref_cfg).state_dict(5)
    assert data_mod.Pipeline.resume_step(p0.state_dict(5)) == 5


def test_checkpoint_roundtrip(tmp_path):
    """Save twice, restore the latest: values and dtypes back, bit for
    bit -- and the JAX package restores the port's file the same."""
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones((4,), dtype=torch.bfloat16)},
            "s": torch.tensor(5, dtype=torch.int32)}
    ckpt.save(tmp_path, 10, tree)
    ckpt.save(tmp_path, 20, tree)
    assert ckpt.latest_step(tmp_path) == 20
    back, meta = ckpt.restore(tmp_path, tree)
    assert meta["step"] == 20
    for x, y in zip(tree_leaves(tree), tree_leaves(back)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(_bits(x), _bits(y))
    ref_like = {"a": jnp.zeros((2, 3), jnp.float32),
                "b": {"c": jnp.zeros((4,), jnp.bfloat16)},
                "s": jnp.asarray(0, jnp.int32)}
    ref_back, ref_meta = ref_ckpt.restore(tmp_path, ref_like)
    assert ref_meta["step"] == 20
    for x, y in zip(tree_leaves(tree), jax.tree.leaves(ref_back)):
        np.testing.assert_array_equal(_bits(x), _bits(y))


def test_checkpoint_retention(tmp_path):
    """keep=2 leaves the two latest steps, as the reference does."""
    for s in (1, 2, 3, 4, 5):
        ckpt.save(tmp_path / "port", s, {"x": torch.zeros((2,))}, keep=2)
        ref_ckpt.save(tmp_path / "ref", s, {"x": jnp.zeros((2,))}, keep=2)
    assert ckpt.all_steps(tmp_path / "port") == [4, 5] == \
        ref_ckpt.all_steps(tmp_path / "ref")
    assert ckpt.latest_step(tmp_path / "none") is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore(tmp_path / "none", {"x": torch.zeros((2,))})


def _fault_run(tmp, model, params, opt_cfg, pipe, total, every, fail_at):
    """A Trainer run with one injected failure at ``fail_at`` (None: no
    failure); returns (trainer, end step, metrics, [(step, loss)])."""
    log, armed = [], {"on": fail_at is not None}

    def fail_hook(step):
        if step == fail_at and armed["on"]:
            armed["on"] = False
            raise RuntimeError("simulated node failure")

    tr = Trainer(RunnerConfig(total_steps=total, ckpt_every=every,
                              ckpt_dir=str(tmp), log_every=100),
                 _recording(jit_train_step(model, opt_cfg), log), params,
                 opt_mod.init(params, opt_cfg), pipe, fail_hook=fail_hook,
                 log=lambda *a: None)
    end, metrics = tr.run()
    return tr, end, metrics, log


def test_runner_end_to_end_with_fault_injection(tmp_path):
    """15 steps of the smoke qwen2-0.5b, checkpoint every 5, one failure
    at step 12: the run recovers once and ends at 15 with its final
    checkpoint, and the replayed steps 10-14 and the final params equal
    an uninterrupted run's bit for bit."""
    _, _, model, params = _setup("qwen2-0.5b")
    opt_cfg = opt_mod.OptConfig(lr=1e-3, warmup_steps=2, total_steps=30)
    pipe = data_mod.Pipeline(data_mod.DataConfig(
        global_batch=2, seq_len=16, vocab=model.cfg.vocab), device="cpu")
    tr, end, metrics, log = _fault_run(tmp_path / "fault", model, params,
                                       opt_cfg, pipe, 15, 5, 12)
    assert end == 15
    assert tr.restarts == 1
    assert np.isfinite(metrics["loss"])
    assert ckpt.latest_step(tmp_path / "fault") == 15
    clean, _, _, clean_log = _fault_run(tmp_path / "clean", model, params,
                                        opt_cfg, pipe, 15, 5, None)
    assert [s for s, _ in log] == list(range(12)) + list(range(10, 15))
    assert log[12:] == clean_log[10:] and log[:12] == clean_log[:12]
    for x, y in zip(tree_leaves(tr.params), tree_leaves(clean.params)):
        np.testing.assert_array_equal(_bits(x), _bits(y))


def test_runner_restores_a_checkpoint_still_being_written(tmp_path,
                                                         monkeypatch):
    """A fault while the last async checkpoint is still being written:
    the runner joins the save and restores it (the reference looks for a
    checkpoint before joining, finds none and restarts from step 0).
    The save is held until the runner joins it."""
    _, _, model, params = _setup("qwen2-0.5b")
    opt_cfg = opt_mod.OptConfig(lr=1e-3, warmup_steps=2, total_steps=30)
    pipe = data_mod.Pipeline(data_mod.DataConfig(
        global_batch=2, seq_len=16, vocab=model.cfg.vocab), device="cpu")
    joined, save, wait = threading.Event(), ckpt.save, ckpt.AsyncSaver.wait

    def held_save(*a, **kw):
        assert joined.wait(timeout=60)
        return save(*a, **kw)

    def joining_wait(self):
        if self._thread is not None:
            joined.set()
        wait(self)

    monkeypatch.setattr(ckpt, "save", held_save)
    monkeypatch.setattr(ckpt.AsyncSaver, "wait", joining_wait)
    tr, end, _, log = _fault_run(tmp_path, model, params, opt_cfg, pipe, 6,
                                 3, 4)
    assert end == 6 and tr.restarts == 1
    assert [s for s, _ in log] == [0, 1, 2, 3, 3, 4, 5]


def test_elastic_remesh_resizing():
    assert elastic_remesh(256, 16, 8) == 32 == \
        ref_runner.elastic_remesh(256, 16, 8)
    for args in ((256, 16, 7), (6, 1, 4)):
        with pytest.raises(AssertionError):
            elastic_remesh(*args)
        with pytest.raises(AssertionError):
            ref_runner.elastic_remesh(*args)


def test_loss_decreases_over_short_run():
    """30 steps of the smoke llama3.2-1b on synthetic data from the JAX
    package's weights: the loss falls by more than 0.2, and each step's
    loss stays within 0.05 of the reference's run (the two runs' bf16
    params part by rounding, so the bound is the arch tests' logit
    bound, not float32 rounding)."""
    ref_model, ref_params, model, params = _setup("llama3.2-1b", seed=1)
    ref_cfg = ref_opt.OptConfig(lr=3e-3, warmup_steps=5, total_steps=30)
    cfg = opt_mod.OptConfig(lr=3e-3, warmup_steps=5, total_steps=30)
    ref_state, state = ref_opt.init(ref_params, ref_cfg), opt_mod.init(
        params, cfg)
    dcfg = dict(global_batch=4, seq_len=32, vocab=model.cfg.vocab)
    ref_pipe = ref_data.Pipeline(ref_data.DataConfig(**dcfg))
    pipe = data_mod.Pipeline(data_mod.DataConfig(**dcfg), device="cpu")
    ref_fn = ref_step.jit_train_step(ref_model, ref_cfg, donate=False)
    step_fn = jit_train_step(model, cfg)
    losses, ref_losses = [], []
    for s in range(30):
        params, state, m = step_fn(params, state, pipe.batch(s))
        ref_params, ref_state, rm = ref_fn(ref_params, ref_state,
                                           ref_pipe.batch(s))
        losses.append(float(m["loss"]))
        ref_losses.append(float(rm["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2
    np.testing.assert_allclose(losses, ref_losses, rtol=0, atol=0.05)


def test_async_checkpoint_saver(tmp_path):
    """Two submits (the second joins the first), then restore the
    latest; the JAX package restores it too."""
    s = ckpt.AsyncSaver()
    tree = {"w": torch.arange(10, dtype=torch.float32)}
    s.submit(tmp_path, 5, tree)
    s.submit(tmp_path, 6, tree)
    s.wait()
    assert ckpt.all_steps(tmp_path) == [5, 6]
    back, meta = ckpt.restore(tmp_path, tree)
    assert meta["step"] == 6
    np.testing.assert_array_equal(back["w"].numpy(),
                                  np.arange(10, dtype=np.float32))
    ref_back, _ = ref_ckpt.restore(tmp_path, {"w": jnp.zeros(10)})
    np.testing.assert_array_equal(np.asarray(ref_back["w"]),
                                  np.arange(10, dtype=np.float32))


def _regression(seed=0):
    """``test_compressed_gradient_allreduce``'s inputs as numpy."""
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (8, 4)).astype(np.float32),
            rng.normal(0, 1, (16, 8)).astype(np.float32),
            rng.normal(0, 1, (16, 4)).astype(np.float32))


def test_compressed_gradient_allreduce():
    """One shard (no group): the compressed gradient is within a
    quantization step of the exact one (the reference's bounds: loss
    1e-4, grads max|g|/40), and the exact gradient agrees with JAX's."""
    w, x, y = _regression()
    params = {"w": torch.from_numpy(w)}
    batch = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}
    loss_fn = torch_train_dist.regression_loss
    loss_c, grads_c = compress.make_compressed_grad_fn(loss_fn)(params,
                                                                batch)
    loss_e, grads_e = value_and_grad(loss_fn)(params, batch)
    assert abs(float(loss_c) - float(loss_e)) < 1e-4
    ge, gc = grads_e["w"].numpy(), grads_c["w"].numpy()
    assert np.abs(gc - ge).max() < np.abs(ge).max() / 40

    def ref_loss(p, b):
        return jnp.mean((b["x"] @ p["w"] - b["y"]) ** 2)

    ref_e = jax.grad(ref_loss)({"w": jnp.asarray(w)},
                               {"x": jnp.asarray(x), "y": jnp.asarray(y)})
    np.testing.assert_allclose(ge, np.asarray(ref_e["w"]), rtol=1e-5,
                               atol=1e-6)


def _shards(world, seed=1):
    """Per-rank gradient shards: an f32 leaf and a bf16 leaf (bits)."""
    rng = np.random.default_rng(seed)
    w = (rng.normal(0, 1, (world, 37, 5))
         * rng.uniform(0.01, 10, (world, 1, 1))).astype(np.float32)
    h = jnp.asarray(rng.normal(0, 0.1, (world, 16, 3)), jnp.bfloat16)
    return w, np.asarray(h).view(np.uint16)


def _ref_compressed_psum(w, h_bits):
    """The reference's ``compressed_psum`` under ``shard_map``, one shard
    per CPU device."""
    world = w.shape[0]
    mesh = Mesh(np.array(jax.devices()[:world]), ("data",))
    fn = jax.jit(shard_map(
        lambda t: ref_compress.compressed_psum(
            jax.tree.map(lambda a: a[0], t), ("data",)),
        mesh=mesh, in_specs=P("data"), out_specs=P(), check_rep=False))
    out = fn({"w": jnp.asarray(w), "b": {"h": jnp.asarray(
        h_bits.view(jnp.bfloat16))}})
    return np.asarray(out["w"]), np.asarray(out["b"]["h"]).view(np.uint16)


def test_compressed_psum_world_size_1_matches_reference():
    """No group: the quantize-dequantize alone, bit-identical to the
    reference's ``compressed_psum`` on a one-device mesh."""
    w, h_bits = _shards(1)
    got = compress.compressed_psum(
        {"w": torch.from_numpy(w[0]),
         "b": {"h": torch.from_numpy(h_bits[0].view(np.int16)).view(
             torch.bfloat16)}})
    want_w, want_h = _ref_compressed_psum(w, h_bits)
    np.testing.assert_array_equal(got["w"].numpy(), want_w)
    np.testing.assert_array_equal(torch_train_dist.bf16_bits(got["b"]["h"]),
                                  want_h)
    q, scale = compress.quantize_leaf(torch.from_numpy(w[0]))
    rq, rscale = ref_compress.quantize_leaf(jnp.asarray(w[0]))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(
        compress.dequantize_leaf(q, scale).numpy(),
        np.asarray(ref_compress.dequantize_leaf(rq, rscale)))


def test_compressed_gradient_allreduce_multidevice(tmp_path):
    """Four gloo ranks in spawned CPU processes against the reference on
    the conftest's 4 CPU devices: ``compressed_psum`` bit-identical on
    every rank; ``make_compressed_grad_fn`` over 4 shards of the
    regression batch within the reference's bounds of the exact full-
    batch gradient, and the same on every rank."""
    world = 4
    assert jax.device_count() >= world
    w, h_bits = _shards(world)
    p, x, y = _regression()
    np.savez(tmp_path / "in.npz", w=w, h_bits=h_bits, p=p, x=x, y=y)
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=torch_train_dist.rank_main,
                         args=(r, world, port, tmp_path / "in.npz",
                               tmp_path / f"out{r}.npz"))
             for r in range(world)]
    try:
        for pr in procs:
            pr.start()
        for pr in procs:
            pr.join(timeout=240)
        assert not any(pr.is_alive() for pr in procs)
    finally:
        for pr in procs:
            if pr.is_alive():
                pr.kill()
    assert [pr.exitcode for pr in procs] == [0] * world
    want_w, want_h = _ref_compressed_psum(w, h_bits)
    params = {"w": torch.from_numpy(p)}
    batch = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}
    loss_e, grads_e = value_and_grad(torch_train_dist.regression_loss)(
        params, batch)
    ge = grads_e["w"].numpy()
    outs = [np.load(tmp_path / f"out{r}.npz") for r in range(world)]
    for out in outs:
        np.testing.assert_array_equal(out["w"], want_w)
        np.testing.assert_array_equal(out["h_bits"], want_h)
        assert abs(float(out["loss"]) - float(loss_e)) < 1e-4
        assert np.abs(out["grad"] - ge).max() < np.abs(ge).max() / 40
        np.testing.assert_array_equal(out["grad"], outs[0]["grad"])


def test_elastic_restart(tmp_path):
    """The one-device counterpart of ``tests/elastic_scenario.py``: train
    6 steps, checkpoint, restore into a fresh ``Trainer`` and continue to
    step 10 -- the losses equal a 10-step uninterrupted run's bit for bit
    (the reference allows 2e-2 across its changed mesh), and stay within
    0.05 of the JAX package's uninterrupted run."""
    ref_model, ref_params, model, params = _setup("qwen2-0.5b")
    cfg = opt_mod.OptConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    dcfg = dict(global_batch=4, seq_len=16, vocab=model.cfg.vocab)
    pipe = data_mod.Pipeline(data_mod.DataConfig(**dcfg), device="cpu")
    step_fn = make_train_step(model, cfg)
    opt0 = opt_mod.init(params, cfg)

    def trainer(total, log, p, o, ckpt_dir, every=100):
        return Trainer(RunnerConfig(total_steps=total, ckpt_every=every,
                                    ckpt_dir=str(ckpt_dir), log_every=100,
                                    async_ckpt=False),
                       _recording(step_fn, log), p, o, pipe,
                       log=lambda *a: None)

    ref_log, l1, l2 = [], [], []
    trainer(10, ref_log, params, opt0, tmp_path / "ref").run()
    assert trainer(6, l1, params, opt0, tmp_path / "elastic",
                   every=6).run()[0] == 6
    fresh = trainer(10, l2, params, opt0, tmp_path / "elastic")
    start = fresh._restore()
    assert start == 6
    end, _ = fresh.run(start)
    assert end == 10
    assert l1 + l2 == ref_log

    ref_cfg = ref_opt.OptConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    ref_fn = jax.jit(ref_step.make_train_step(ref_model, ref_cfg))
    ref_pipe = ref_data.Pipeline(ref_data.DataConfig(**dcfg))
    rp, rs, jax_losses = ref_params, ref_opt.init(ref_params, ref_cfg), []
    for s in range(10):
        rp, rs, m = ref_fn(rp, rs, ref_pipe.batch(s))
        jax_losses.append(float(m["loss"]))
    np.testing.assert_allclose([v for _, v in ref_log], jax_losses, rtol=0,
                               atol=0.05)


def test_file_backed_data_pipeline(tmp_path):
    """memmap token-file source: deterministic, in-vocab, windows from the
    file, resumable -- and bit-identical to the reference's."""
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 1000, 4096).astype(np.uint16)
    fp = tmp_path / "tokens.bin"
    toks.tofile(fp)
    kw = dict(seed=3, global_batch=4, seq_len=32, vocab=1000, path=str(fp))
    pipe = data_mod.Pipeline(data_mod.DataConfig(**kw), device="cpu")
    b1 = pipe.batch(7)["tokens"].numpy()
    np.testing.assert_array_equal(b1, pipe.batch(7)["tokens"].numpy())
    assert b1.shape == (4, 32) and b1.dtype == np.int32
    assert (b1 >= 0).all() and (b1 < 1000).all()
    flat = b1[0]
    assert any((toks[i:i + 32] == flat).all() for i in range(len(toks) - 32))
    ref = ref_data.Pipeline(ref_data.DataConfig(**kw))
    for host in (0, 1):
        port = data_mod.Pipeline(data_mod.DataConfig(**kw), host_id=host,
                                 n_hosts=2, device="cpu")
        ref = ref_data.Pipeline(ref_data.DataConfig(**kw), host_id=host,
                                n_hosts=2)
        for step in (0, 7, 8):
            np.testing.assert_array_equal(
                port.batch(step)["tokens"].numpy(),
                np.asarray(ref.batch(step)["tokens"]))


# ---------------------------------------------------------------------------
# the slice, module by module
# ---------------------------------------------------------------------------
#: each gradient leaf within this share of the leaf's largest |g| (the
#: worst measured: 0.033, recurrentgemma-9b); the loss within rtol 1e-3
GRAD_SHARE, LOSS_RTOL = 0.05, 1e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_reference(arch):
    """``value_and_grad(model.loss)`` against ``jax.value_and_grad`` of
    the reference's loss on its weights: the loss within rtol 1e-3, every
    leaf's gradient in the leaf's dtype and within 0.05 of its largest
    |g|."""
    ref_model, ref_params, model, params = _setup(arch)
    ref_batch, batch = _batch(model.cfg, np.random.default_rng(1))
    ref_loss, ref_grads = run_ref(jax.value_and_grad(ref_model.loss),
                                  ref_params, ref_batch)
    loss, grads = value_and_grad(model.loss)(params, batch)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=LOSS_RTOL)
    got, want = tree_leaves(grads), jax.tree.leaves(ref_grads)
    assert len(got) == len(want) == len(tree_leaves(params))
    for i, (g, w) in enumerate(zip(got, want)):
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
        w = np.asarray(w, np.float32)
        err = np.abs(_f32(g) - w).max()
        assert err <= GRAD_SHARE * np.abs(w).max(), (i, err)


class _CountMatmuls(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                    torch.ops.aten.bmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "falcon-mamba-7b",
                                  "seamless-m4t-large-v2"])
def test_remat_policies_give_identical_grads(arch):
    """"full", "dots" and "none" give the same loss and gradients bit for
    bit, and really rematerialize: the backward pass runs the most
    matmuls under "full" (the whole layer again), fewer under "dots"
    (its saved matmuls are not recomputed), the fewest under "none" --
    except the encoder of an encoder-decoder, rematerialized in full
    under every policy, as in the reference."""
    ref_batch, batch = _batch(configs.get_config(arch, smoke=True),
                              np.random.default_rng(2))
    out, backward_mms = {}, {}
    for policy in ("full", "dots", "none"):
        _, _, model, params = _setup(arch, remat_policy=policy)
        leaves, treedef = tree_flatten(params)
        xs = [x.detach().requires_grad_() for x in leaves]
        loss = model.loss(tree_unflatten(treedef, xs), batch)
        with _CountMatmuls() as count:
            grads = torch.autograd.grad(loss, xs, allow_unused=True,
                                        materialize_grads=True)
        out[policy] = (loss.detach(), grads)
        backward_mms[policy] = count.n
    for policy in ("dots", "none"):
        np.testing.assert_array_equal(_bits(out[policy][0]),
                                      _bits(out["full"][0]))
        for g, f in zip(out[policy][1], out["full"][1]):
            np.testing.assert_array_equal(_bits(g), _bits(f))
    assert backward_mms["full"] > backward_mms["dots"] > \
        backward_mms["none"], backward_mms
    with torch.no_grad():        # no recording: the plain forward
        _, _, model, params = _setup(arch)
        np.testing.assert_array_equal(_bits(model.loss(params, batch)),
                                      _bits(out["none"][0]))


def test_optimizer_apply_matches_reference():
    """Six steps across the warm-up/cosine boundary (warm-up 3, total 8),
    clipping on in some steps, each from the reference's state: ``lr``,
    ``mu``, ``nu`` and ``grad_norm`` within rtol 1e-5, bf16 params within
    one bf16 step and float32 params within rtol 1e-5 of the
    reference's; the dict's insertion order is not sorted."""
    ref_cfg = ref_opt.OptConfig(lr=1e-2, warmup_steps=3, total_steps=8)
    cfg = opt_mod.OptConfig(lr=1e-2, warmup_steps=3, total_steps=8)
    rng = np.random.default_rng(4)

    def tree(scale=1.0):
        return {"w": jnp.asarray(rng.normal(0, scale, (16, 8)),
                                 jnp.bfloat16),
                "n": jnp.asarray(rng.normal(0, scale, (8,)), jnp.float32),
                "u": {"z": jnp.asarray(rng.normal(0, scale, (2, 3, 4)),
                                       jnp.bfloat16)}}

    ref_params = tree()
    ref_state = ref_opt.init(ref_params, ref_cfg)
    lrs = []
    for step, gscale in enumerate((0.01, 0.5, 0.02, 2.0, 0.01, 0.05)):
        grads = tree(gscale)
        new_p, new_s, m = ref_opt.apply(ref_params, grads, ref_state,
                                        ref_cfg)
        p, s, pm = opt_mod.apply(to_torch(ref_params), to_torch(grads),
                                 _state_to_torch(ref_state), cfg)
        assert int(s.step) == int(new_s.step) == step + 1
        for k in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(pm[k]), float(m[k]), rtol=1e-5)
        for a, b in zip(tree_leaves(s.mu) + tree_leaves(s.nu),
                        jax.tree.leaves(new_s.mu) + jax.tree.leaves(new_s.nu)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-30)
        for a, b in zip(tree_leaves(p), jax.tree.leaves(new_p)):
            assert str(a.dtype).split(".")[-1] == str(b.dtype)
            if a.dtype == torch.bfloat16:
                assert (np.abs(_f32(a) - _f32(b)) <= _bf16_step(b)).all()
            else:
                np.testing.assert_allclose(_f32(a), _f32(b), rtol=1e-5)
        lrs.append(float(m["lr"]))
        ref_params, ref_state = new_p, new_s
    # the schedule peaks at the end of the warm-up, then decays
    assert lrs[:3] == sorted(lrs[:3]) and lrs[3:] == sorted(lrs[3:])[::-1]


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_reference(accum):
    """One train step of the smoke qwen2-0.5b against the reference's
    ``make_train_step`` on its weights and the same batch: loss and
    ``grad_norm`` within rtol 1e-2; new params within 2*lr*(1 + wd*|p|)
    plus one bf16 step elementwise (two step-1 Adam updates are each
    lr*(~+-1 + wd*p), so a gradient of opposite sign in the two packages
    moves an element by at most that much)."""
    ref_model, ref_params, model, params = _setup("qwen2-0.5b")
    ref_cfg = ref_opt.OptConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    cfg = opt_mod.OptConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    ref_state = ref_opt.init(ref_params, ref_cfg)
    toks = data_mod.Pipeline(data_mod.DataConfig(
        global_batch=4, seq_len=16, vocab=model.cfg.vocab),
        device="cpu").batch(0)["tokens"]
    rp, _, rm = run_ref(ref_step.make_train_step(ref_model, ref_cfg, accum),
                        ref_params, ref_state,
                        {"tokens": jnp.asarray(toks.numpy())})
    p, s, m = make_train_step(model, cfg, accum)(
        params, _state_to_torch(ref_state), {"tokens": toks})
    assert int(s.step) == 1
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(rm[k]), rtol=1e-2)
    lr = float(rm["lr"])
    for a, b, p0 in zip(tree_leaves(p), jax.tree.leaves(rp),
                        jax.tree.leaves(ref_params)):
        bound = 2 * lr * (1 + cfg.weight_decay * np.abs(_f32(p0))) \
            + _bf16_step(b)
        assert (np.abs(_f32(a) - _f32(b)) <= bound).all()


def test_src_embeds_bit_identical_to_reference():
    """Encoder-decoder batches: ``src_embeds`` rounded from float64 to
    bf16 as ``jnp.asarray(emb, jnp.bfloat16)`` rounds them, over all
    7,340,032 normals of one draw at seamless-m4t-large-v2's width, and
    per host."""
    kw = dict(seed=5, global_batch=4, seq_len=8, vocab=256, src_len=1792,
              d_model=1024)
    got = data_mod.Pipeline(data_mod.DataConfig(**kw), device="cpu").batch(2)
    want = ref_data.Pipeline(ref_data.DataConfig(**kw)).batch(2)
    assert got["src_embeds"].dtype == torch.bfloat16
    assert got["src_embeds"].numel() == 7_340_032
    np.testing.assert_array_equal(_bits(got["src_embeds"]),
                                  _bits(want["src_embeds"]))
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))
    small = dict(kw, src_len=8, d_model=16)
    for host in (0, 1):
        g = data_mod.Pipeline(data_mod.DataConfig(**small), host_id=host,
                              n_hosts=2, device="cpu").batch(3)
        w = ref_data.Pipeline(ref_data.DataConfig(**small), host_id=host,
                              n_hosts=2).batch(3)
        np.testing.assert_array_equal(_bits(g["src_embeds"]),
                                      _bits(w["src_embeds"]))


def test_checkpoints_load_across_packages(tmp_path):
    """A Trainer-shaped tree (params, optimizer state, data state) whose
    dict insertion order is not sorted, with python-int leaves: written
    by the JAX package it loads in the port, written by the port it
    loads in the JAX package, bit for bit, and the two ``arrays.npz``
    hold the same names, dtypes and values."""
    rng = np.random.default_rng(6)
    w = jnp.asarray(rng.normal(0, 1, (4, 3)), jnp.bfloat16)
    n = jnp.asarray(rng.normal(0, 1, (3,)), jnp.float32)
    mu = {"w": jnp.asarray(rng.normal(0, 1, (4, 3)), jnp.float32),
          "n": jnp.asarray(rng.normal(0, 1, (3,)), jnp.float32)}
    ref_tree = {"params": {"w": w, "n": n},
                "opt": ref_opt.OptState(jnp.asarray(7, jnp.int32), mu,
                                        jax.tree.map(jnp.square, mu)),
                "data": {"step": 7, "seed": 3, "global_batch": 4}}
    port_tree = {"params": {"w": to_torch(w), "n": to_torch(n)},
                 "data": {"step": 7, "seed": 3, "global_batch": 4},
                 "opt": _state_to_torch(ref_tree["opt"])}
    assert list(port_tree) != sorted(port_tree)
    ref_ckpt.save(tmp_path / "jax", 7, ref_tree)
    ckpt.save(tmp_path / "port", 7, port_tree)
    with np.load(tmp_path / "jax" / "step_00000007" / "arrays.npz") as a, \
            np.load(tmp_path / "port" / "step_00000007" / "arrays.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k])

    zeros_port = tree_map(lambda x: torch.zeros_like(x)
                          if isinstance(x, torch.Tensor) else 0, port_tree)
    back, meta = ckpt.restore(tmp_path / "jax", zeros_port)
    assert meta["step"] == 7 and back["data"] == port_tree["data"]
    assert isinstance(back["opt"], opt_mod.OptState)
    zeros_ref = jax.tree.map(lambda x: jnp.zeros_like(x)
                             if hasattr(x, "dtype") else 0, ref_tree)
    ref_back, _ = ref_ckpt.restore(tmp_path / "port", zeros_ref)
    assert ref_back["data"] == ref_tree["data"]
    for x, y, z in zip(tree_leaves(back), jax.tree.leaves(ref_tree),
                       jax.tree.leaves(ref_back)):
        if isinstance(x, int):
            assert x == y == z
            continue
        assert str(x.dtype).split(".")[-1] == str(y.dtype)
        np.testing.assert_array_equal(_bits(x), _bits(y))
        np.testing.assert_array_equal(_bits(z), _bits(y))
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(tmp_path / "port",
                     dict(zeros_port, params={"w": torch.zeros(4, 4),
                                              "n": torch.zeros(3)}))


def test_async_saver_snapshots_before_in_place_update(tmp_path,
                                                      monkeypatch):
    """``submit`` copies the tensors before it returns: an in-place
    update made after it, while the save is held back, is not in the
    checkpoint."""
    release = threading.Event()
    save = ckpt.save

    def held_save(*a, **kw):
        assert release.wait(timeout=60)
        return save(*a, **kw)

    monkeypatch.setattr(ckpt, "save", held_save)
    w = torch.arange(10, dtype=torch.float32)
    h = torch.ones(3, dtype=torch.bfloat16)
    s = ckpt.AsyncSaver()
    s.submit(tmp_path, 1, {"w": w, "h": h})
    w.add_(100)
    h.mul_(3)
    release.set()
    s.wait()
    back, _ = ckpt.restore(tmp_path, {"w": w, "h": h})
    np.testing.assert_array_equal(back["w"].numpy(),
                                  np.arange(10, dtype=np.float32))
    assert (back["h"] == 1).all()


def test_train_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        data_mod.Pipeline(data_mod.DataConfig())
    state = ref_opt.init({"w": jnp.zeros(2)}, ref_opt.OptConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        opt_mod.opt_state_from_numpy(jax.tree.map(np.asarray, state))
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_train.main(["--arch", "qwen2-0.5b", "--steps", "1"])


def test_launch_train_runs_and_resumes_on_the_cpu(tmp_path, capsys):
    """``python -m repro_torch.launch.train`` on the CPU: 3 steps with a
    checkpoint every 2, then a second run to 4 steps resumes from the
    final checkpoint at 3; a mesh larger than the process group (one
    rank, without a launcher) is refused, naming the ranks it needs."""
    args = ["--arch", "qwen2-0.5b", "--batch", "2", "--seq", "16",
            "--device", "cpu", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "2"]
    launch_train.main(args + ["--steps", "3"])
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith(
        "finished at step 3: {")
    assert ckpt.all_steps(tmp_path) == [2, 3]
    launch_train.main(args + ["--steps", "4"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert "resuming from step 3" in lines
    assert lines[-1].startswith("finished at step 4: {")
    with pytest.raises(ValueError, match="needs 2 ranks"):
        launch_train.main(args + ["--data", "2"])


def test_smoke_train_phase_on_the_cpu():
    """``chip_smoke.phase_train`` at smoke widths on the CPU: 8 steps with
    one restart, replay bit-identical, the entry point's 4 steps, and no
    kernel launched."""
    res = chip_smoke.phase_train(
        0, dev="cpu", cfg=configs.get_config("qwen2-0.5b", smoke=True),
        batch=2, seq=16, cpu_tokens=8, launch_args=("--device", "cpu"))
    assert res["restarts"] == 1 and res["latest"] == 8
    assert [s for s, _ in res["replayed"]] == list(range(3, 8))
    assert res["launch_rc"] == 0
    before, after = res["kernel_launches"]
    assert before == after
