"""The port's launch layer against the JAX package's, on the CPU.

The counterparts of ``tests/test_launch.py``'s four tests (collective
accounting, roofline terms, the divisibility guard, a dry-run cell in a
subprocess) and of ``tests/elastic_scenario.py`` on a real multi-rank
mesh, then the layer module by module: the mesh hooks of
``models/common.py``, the sharding rules leaf for leaf against the JAX
package's for all ten architectures on the (2, 2), (16, 16) and
(2, 16, 16) meshes, ``analytic_terms``, ``input_specs``, ``SHAPES`` and
``PLANS``, the dry-run's measurements, training through the mesh on one
and on four gloo ranks, and the entry points.

The JAX package's ``launch/dryrun.py`` and ``launch/perf.py`` set
``XLA_FLAGS`` to 512 host devices when they are imported, so this file
never imports them: ``PLANS`` is read from the source by ``ast``.
"""

import ast
import dataclasses
import json
import multiprocessing
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh, AxisType  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.launch import analysis as ref_analysis  # noqa: E402
from repro.launch import shapes as ref_shapes  # noqa: E402
from repro.launch import sharding as ref_sharding  # noqa: E402
from repro.launch.mesh import make_mesh as ref_make_mesh  # noqa: E402
from repro.models.common import resolve_spec as ref_resolve_spec  # noqa
from repro.models.model import LM as RefLM  # noqa: E402
from repro.models.qweight import quantize_tree as ref_quantize  # noqa
from repro.train import data as ref_data  # noqa: E402
from repro.train import optimizer as ref_opt  # noqa: E402
from repro.train.step import make_train_step as ref_train_step  # noqa
from repro_torch import configs  # noqa: E402
from repro_torch.launch import analysis, dryrun, perf, shapes  # noqa: E402
from repro_torch.launch import sharding  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.launch.mesh import (data_parallel_size,  # noqa: E402
                                     make_mesh, make_production_mesh)
from repro_torch.models import common  # noqa: E402
from repro_torch.models import model as model_mod  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.models.qweight import quantize_tree  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import data as data_mod  # noqa: E402
from repro_torch.train import optimizer as opt_mod  # noqa: E402
from repro_torch.train.step import make_train_step  # noqa: E402
from repro_torch.train.tree import tree_leaves  # noqa: E402
import elastic_scenario  # noqa: E402
import torch_launch_dist  # noqa: E402
from test_launch import HLO  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCHS = configs.list_archs()
MESHES = {(2, 2): ("data", "model"), (16, 16): ("data", "model"),
          (2, 16, 16): ("pod", "data", "model")}


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------
def _mesh(shape):
    """The port's mesh of ``shape`` in the current (fake) group."""
    if shape == (2, 16, 16):
        return make_production_mesh(multi_pod=True, device_type="cpu")
    if shape == (16, 16):
        return make_production_mesh(device_type="cpu")
    return make_mesh(*shape, device_type="cpu")


def _ref_mesh(shape):
    """The JAX package's mesh: conftest's 4 host devices for (2, 2), an
    ``AbstractMesh`` for the production shapes."""
    if shape == (2, 2):
        return ref_make_mesh(2, 2)
    return AbstractMesh(shape, MESHES[shape])


def _fake_tree(fn):
    """``fn()``'s tree of fake tensors (nothing is allocated)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        return fn()


def _by_path(ref_tree, port_tree):
    """{path: leaf} of a JAX tree (the reference's path keys) and of the
    port's tree (``sharding.map_with_path``)."""
    ref = {tuple(getattr(p, "key", getattr(p, "name", str(p)))
                 for p in path): leaf
           for path, leaf in jax.tree_util.tree_flatten_with_path(
               ref_tree)[0]}
    port = {}
    sharding.map_with_path(lambda path, leaf: port.__setitem__(path, leaf),
                           port_tree)
    return ref, port


def _spec(p):
    """A ``PartitionSpec`` as the port's tuple spec."""
    return tuple(tuple(s) if isinstance(s, (list, tuple)) else s for s in p)


def _assert_same_shardings(ref_avals, ref_sh, port_tree, port_sh):
    """Leaf for leaf: equal paths, shapes, specs and shard shapes."""
    ref_leaves, port_leaves = _by_path(ref_avals, port_tree)
    ref_specs, port_specs = _by_path(ref_sh, port_sh)
    assert ref_leaves.keys() == port_leaves.keys() == ref_specs.keys() \
        == port_specs.keys()
    for path, want in ref_specs.items():
        shape = tuple(ref_leaves[path].shape)
        assert tuple(port_leaves[path].shape) == shape, path
        got = port_specs[path]
        assert got.spec == _spec(want.spec), (path, got.spec, want.spec)
        assert got.shard_shape(shape) == tuple(want.shard_shape(shape)), path


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(world, *args, target=torch_launch_dist.rank_main):
    """Run ``target`` (a ``torch_launch_dist`` worker) on ``world`` gloo
    ranks."""
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=target, args=(r, world, port, *args))
             for r in range(world)]
    try:
        for pr in procs:
            pr.start()
        for pr in procs:
            pr.join(timeout=300)
        assert not any(pr.is_alive() for pr in procs)
    finally:
        for pr in procs:
            if pr.is_alive():
                pr.kill()
    assert [pr.exitcode for pr in procs] == [0] * world


# ---------------------------------------------------------------------------
# the counterparts of tests/test_launch.py
# ---------------------------------------------------------------------------
def test_collective_recorder_matches_hlo_parsing():
    """The reference's HLO: 24 trips of an all-reduce of f32[128,256] and
    an all-gather to f32[256,256], then an all-reduce of f32[64].  The
    same program run eagerly on a fake 8-rank group records the same
    bytes, to the byte, in 49 collectives."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.device_mesh import init_device_mesh
    with dryrun.fake_group(8):
        mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("a", "b"))
        x, y = torch.zeros(128, 256), torch.zeros(64)
        rec = analysis.CollectiveRecorder()
        with rec:
            for _ in range(24):
                r = funcol.all_reduce(x, "sum", (mesh, 0)).wait()
                g = funcol.all_gather_single(r, 0, (mesh, 1)).wait()
                assert tuple(g.shape) == (256, 256)
            funcol.all_reduce(y, "sum", (mesh, 0)).wait()
    st = analysis.collective_bytes(rec.records)
    want = 128 * 256 * 4 * 2 * 24 + 256 * 256 * 4 * 24 + 64 * 4 * 2
    assert st.total_bytes == want == ref_analysis.collective_bytes(
        HLO).total_bytes
    assert st.count == 49
    assert st.bytes_by_kind.keys() == ref_analysis.collective_bytes(
        HLO).bytes_by_kind.keys()
    assert st.bytes_by_kind["all-gather"] == 256 * 256 * 4 * 24


def test_roofline_terms():
    r = analysis.roofline(analysis.PEAK_FLOPS * 256,
                          analysis.HBM_BW * 256, 0.0, 256)
    assert abs(r["t_compute_s"] - 1.0) < 1e-9
    assert abs(r["t_memory_s"] - 1.0) < 1e-9
    assert r["dominant"] in ("compute", "memory")
    assert r.keys() == ref_analysis.roofline(1.0, 1.0, 1.0, 1).keys()
    # the H100 SXM5's, not a TPU's
    assert (analysis.PEAK_FLOPS, analysis.HBM_BW, analysis.ICI_BW) == (
        989.4e12, 3.35e12, 450e9)


def test_resolve_spec_divisibility_guard():
    with dryrun.fake_group(1):
        mesh = make_mesh(1, 1, device_type="cpu")
        assert common.resolve_spec(mesh, (14, 64), ("model", None)) == \
            ("model", None) == tuple(ref_resolve_spec(
                jax.make_mesh((1, 1), ("data", "model")), (14, 64),
                ("model", None)))
    with dryrun.fake_group(16):
        mesh = make_mesh(1, 16, device_type="cpu")
        # 14 heads on a 16-way model axis stay replicated
        assert common.resolve_spec(mesh, (14, 64), ("model", None)) == \
            (None, None)
        # "batch" expands to present axes only; absent axes drop
        assert common.resolve_spec(mesh, (8, 16), ("batch", "pod")) == \
            ("data", None)
    with dryrun.fake_group(1):
        from torch.distributed.device_mesh import init_device_mesh
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("model",))
        assert common.resolve_spec(mesh, (8, 16), ("batch", "data")) == \
            (None, None)


def test_dryrun_cell_subprocess(tmp_path):
    """End-to-end dry-run of one real cell on the 256-rank mesh, on fake
    CPU tensors; its arguments are the bytes of the JAX package's shards
    of the same cell on the same mesh."""
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
           "--arch", "qwen2-0.5b", "--shape", "decode_32k",
           "--device", "cpu", "--out", str(tmp_path)]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                       cwd=ROOT, env={"PYTHONPATH": "src",
                                      "PATH": "/usr/bin:/bin",
                                      "HOME": str(tmp_path)})
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(
        (tmp_path / "qwen2-0.5b__decode_32k__single.json").read_text())
    assert out["status"] == "ok"
    assert out["chips"] == 256
    assert out["collective_bytes"] > 0
    # the vocab-split table is read where it lies: nothing is gathered
    assert out["collective_by_kind"]["all-gather"] == 0
    assert out["memory_analysis"]["temp_size_in_bytes"] > 0
    for key in ("analytic_flops", "analytic_bytes", "model_flops_6nd",
                "counted_flops", "counted_bytes", "collective_by_kind",
                "params_b", "active_params_b", "compile_s"):
        assert key in out

    # the JAX rules' shard bytes of params, caches, tokens and pos
    cfg = ref_configs.get_config("qwen2-0.5b")
    model = RefLM(cfg)
    mesh = AbstractMesh((16, 16), ("data", "model"))
    sh = ref_shapes.SHAPES["decode_32k"]
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    cache = jax.eval_shape(lambda: model.init_cache(sh["batch"], sh["seq"]))
    spec = ref_shapes.input_specs(cfg, "decode_32k")
    trees = [(params, ref_sharding.params_sharding(params, mesh)),
             (cache, ref_sharding.cache_sharding(cache, mesh))]
    for k in ("tokens", "pos"):
        trees.append((spec[k], ref_sharding.batch_sharding(spec[k], mesh)))
    want = sum(int(np.prod(s.shard_shape(a.shape))) * a.dtype.itemsize
               for tree, shs in trees
               for a, s in zip(jax.tree.leaves(tree), jax.tree.leaves(shs)))
    assert out["memory_analysis"]["argument_size_in_bytes"] == want


#: per-rank temp of train_4k on 256 ranks: 132.8 GB while the loss ran on
#: all-gathered float32 logits, ~43.8 GB with the vocabulary kept split
TRAIN_4K_TEMP_MAX = 48e9


@pytest.mark.parametrize("shape", ["prefill_32k", "train_4k"])
def test_dryrun_keeps_the_vocabulary_split(shape, tmp_path):
    """qwen2-0.5b's prefill_32k and train_4k on 256 fake CPU ranks, as the
    reference's GSPMD program partitions them: the embedding table and
    the logits stay split on "model", so prefill gathers nothing and
    train_4k's per-rank temp fits under 48 GB."""
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
           "--arch", "qwen2-0.5b", "--shape", shape,
           "--device", "cpu", "--out", str(tmp_path)]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                       cwd=ROOT, env={"PYTHONPATH": "src",
                                      "PATH": "/usr/bin:/bin",
                                      "HOME": str(tmp_path)})
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(
        (tmp_path / f"qwen2-0.5b__{shape}__single.json").read_text())
    assert out["status"] == "ok" and out["chips"] == 256
    assert out["collective_by_kind"]["all-reduce"] > 0
    if shape == "prefill_32k":
        assert out["collective_by_kind"]["all-gather"] == 0
    else:
        assert 0 < out["memory_analysis"]["temp_size_in_bytes"] \
            <= TRAIN_4K_TEMP_MAX


# ---------------------------------------------------------------------------
# models/common.py: the mesh hooks
# ---------------------------------------------------------------------------
def test_mesh_hooks_and_placements():
    from torch.distributed.tensor import (Partial, Replicate, Shard,
                                          distribute_tensor)
    x = torch.arange(8.0).reshape(2, 4)
    assert common.shard(x, "batch", "model") is x       # no mesh
    with dryrun.fake_group(512):
        mesh = _mesh((2, 16, 16))
        assert data_parallel_size(mesh) == 32
        assert common.batch_axes(mesh) == ("pod", "data")
        assert common.spec_to_placements(mesh, common.resolve_spec(
            mesh, (64, 7), ("batch", None))) == [Shard(0), Shard(0),
                                                  Replicate()]
        assert common.spec_for(mesh, "batch", "model", "x") == (
            ("pod", "data"), "model", None)
    with dryrun.fake_group(4):
        mesh = _mesh((2, 2))
        assert common.spec_to_placements(mesh, (None, "model")) == [
            Replicate(), Shard(1)]
        d = distribute_tensor(x, mesh, [Replicate(), Replicate()],
                              src_data_rank=None)
        assert common.shard(d, "batch", None) is d      # no active mesh
        with common.use_mesh(mesh):
            assert common._active_mesh() is mesh
            assert common.shard(x, "batch", None) is x  # a plain tensor
            y = common.shard(d, "batch", "model")
            assert list(y.placements) == [Shard(0), Shard(1)]
            assert tuple(y.to_local().shape) == (1, 2)
            # plain tensors meet DTensors as replicated
            assert (d + torch.ones(2, 4)).placements == d.placements
            p = distribute_tensor(x, mesh, [Partial(), Replicate()],
                                  src_data_rank=None)
            assert list(common.replicate(p).placements) == [Replicate()] * 2
            assert list(common.shard_like(p, y).placements) == [Shard(0),
                                                                Shard(1)]
        assert common._active_mesh() is None


# ---------------------------------------------------------------------------
# launch/sharding.py: the rules against the JAX package's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mesh_shape", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_sharding_rules_match_reference(arch, mesh_shape):
    """``params_sharding``, ``opt_sharding``'s step, ``cache_sharding``
    and ``batch_sharding`` give the JAX package's partition spec and shard
    shape for every leaf of every arch at its published widths; on
    qwen2-0.5b also for its int8 and bit-plane packed weights."""
    ref_cfg, cfg = ref_configs.get_config(arch), configs.get_config(arch)
    ref_model, model = RefLM(ref_cfg), LM(cfg, "cpu")
    chips = int(np.prod(mesh_shape))
    ref_mesh = _ref_mesh(mesh_shape)
    variants = [None] + ([8, 4] if arch == "qwen2-0.5b" else [])
    with dryrun.fake_group(chips):
        mesh = _mesh(mesh_shape)
        for bits in variants:
            def ref_init(k):
                p = ref_model.init(k)
                return ref_quantize(p, bits=bits) if bits else p

            def port_init():
                p = model.init(torch.Generator().manual_seed(0))
                return quantize_tree(p, bits=bits) if bits else p
            ref_p = jax.eval_shape(ref_init, jax.random.PRNGKey(0))
            port_p = _fake_tree(port_init)
            _assert_same_shardings(
                ref_p, ref_sharding.params_sharding(ref_p, ref_mesh),
                port_p, sharding.params_sharding(port_p, mesh))
        assert sharding.opt_sharding(None, {}, mesh).step.spec == ()
        sh = shapes.SHAPES["decode_32k"]
        ref_c = jax.eval_shape(
            lambda: ref_model.init_cache(sh["batch"], sh["seq"]))
        port_c = _fake_tree(lambda: model.init_cache(sh["batch"],
                                                     sh["seq"]))
        _assert_same_shardings(
            ref_c, ref_sharding.cache_sharding(ref_c, ref_mesh),
            port_c, sharding.cache_sharding(port_c, mesh))
        for name in shapes.SHAPES:
            ref_in = ref_shapes.input_specs(ref_cfg, name)
            port_in = shapes.input_specs(cfg, name)
            _assert_same_shardings(
                ref_in, ref_sharding.batch_sharding(ref_in, ref_mesh),
                port_in, sharding.batch_sharding(port_in, mesh))


# ---------------------------------------------------------------------------
# launch/shapes.py, analysis.py and perf.py against the reference
# ---------------------------------------------------------------------------
def _ref_weight_bits():
    """The reference dry-run's ``if wq_bits:`` block of ``lower_cell``,
    read from its source (importing that module sets ``XLA_FLAGS``)."""
    src = (ROOT / "src/repro/launch/dryrun.py").read_text()
    fn = next(n for n in ast.parse(src).body
              if isinstance(n, ast.FunctionDef) and n.name == "lower_cell")
    block = next(n for n in fn.body if isinstance(n, ast.If)
                 and getattr(n.test, "id", None) == "wq_bits")
    code = compile(ast.Module(body=[block], type_ignores=[]), "<ref>",
                   "exec")

    def run(res, cfg, wq_bits):
        exec(code, {}, {"res": res, "cfg": cfg, "wq_bits": wq_bits})
        return res
    return run


@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_terms_match_reference(arch):
    """Every shape at 1, 256 and 512 chips, with the cache in bf16, int8
    and int4 and the weights in bf16, int8 and int4 planes, equal to the
    reference's bit for bit; the shapes' stand-ins and skip rules as the
    reference's."""
    ref_wq = _ref_weight_bits()
    for kv in (None, 8, 4):
        cfg = dataclasses.replace(configs.get_config(arch),
                                  kv_quant_bits=kv)
        ref_cfg = dataclasses.replace(ref_configs.get_config(arch),
                                      kv_quant_bits=kv)
        for name in shapes.SHAPES:
            assert shapes.applicable(cfg, name) == \
                ref_shapes.applicable(ref_cfg, name)
            assert shapes.skip_reason(cfg, name) == \
                ref_shapes.skip_reason(ref_cfg, name)
            for chips in (1, 256, 512):
                assert analysis.analytic_terms(cfg, name, chips) == \
                    ref_analysis.analytic_terms(ref_cfg, name, chips)
                for wq in (8, 4):
                    assert dryrun.with_weight_bits(
                        analysis.analytic_terms(cfg, name, chips), cfg,
                        wq) == ref_wq(ref_analysis.analytic_terms(
                            ref_cfg, name, chips), ref_cfg, wq)
            ref_in, port_in = _by_path(ref_shapes.input_specs(ref_cfg, name),
                                       shapes.input_specs(cfg, name))
            assert ref_in.keys() == port_in.keys()
            for path, want in ref_in.items():
                got = port_in[path]
                assert tuple(got.shape) == tuple(want.shape), path
                assert str(got.dtype).removeprefix("torch.") == \
                    jnp.dtype(want.dtype).name, path


def test_shapes_and_plans_match_reference():
    assert shapes.SHAPES == ref_shapes.SHAPES
    assert shapes.ENC_SRC_LEN == ref_shapes.ENC_SRC_LEN
    src = (ROOT / "src/repro/launch/perf.py").read_text()
    plans = next(ast.literal_eval(node.value)
                 for node in ast.parse(src).body
                 if isinstance(node, ast.Assign)
                 and getattr(node.targets[0], "id", None) == "PLANS")
    assert perf.PLANS == plans
    assert dryrun.ALL_CELLS == [(a, s) for a in ref_configs.list_archs()
                                for s in ref_shapes.SHAPES]
    cfg = dryrun.apply_overrides(configs.get_config("granite-moe-3b-a800m"),
                                 {"moe.dispatch_chunks": 32,
                                  "kv_quant_bits": 8})
    assert (cfg.moe.dispatch_chunks, cfg.kv_quant_bits) == (32, 8)


# ---------------------------------------------------------------------------
# launch/dryrun.py: what one traced step measures
# ---------------------------------------------------------------------------
def test_dryrun_steps_at_smoke_widths():
    """Decode, prefill and train of qwen2-0.5b's smoke config (4 heads,
    d_ff 256: "model" really splits) on a fake (2, 2) mesh, with bit-plane
    weights on the decode: every step traces, runs collectives, and
    holds a temp; one rank's arguments are the sum of its shards."""
    cfg = configs.get_config("qwen2-0.5b", smoke=True)
    cells = {"decode": {"kind": "decode", "seq": 64, "batch": 8},
             "prefill": {"kind": "prefill", "seq": 64, "batch": 8},
             "train": {"kind": "train", "seq": 32, "batch": 8}}
    with dryrun.fake_group(4):
        mesh = _mesh((2, 2))
        out = {k: dryrun.trace_step(cfg, sh, mesh, device="cpu")
               for k, sh in cells.items()}
        q = dryrun.trace_step(cfg, cells["decode"], mesh, wq_bits=4,
                              device="cpu")
    for k, r in out.items():
        assert r["collective_ops"] > 0 and r["collective_bytes"] > 0, k
        assert r["memory_analysis"]["temp_size_in_bytes"] > 0, k
        assert r["counted_flops"] > 0 and r["counted_bytes"] > 0, k
        assert r["scan_trip_multiplier"] == 1.0
    # decode: the model's params, the cache and the (B, 1) tokens and
    # (B,) positions, each split by the rules
    model = LM(cfg, "cpu")
    params = _fake_tree(lambda: model.init(torch.Generator()))
    cache = _fake_tree(lambda: model.init_cache(8, 64))
    with dryrun.fake_group(4):
        mesh = _mesh((2, 2))
        want = sum(
            int(np.prod(s.shard_shape(t.shape))) * t.element_size()
            for tree, shs in ((params, sharding.params_sharding(params,
                                                               mesh)),
                              (cache, sharding.cache_sharding(cache, mesh)))
            for t, s in zip(dryrun._tensors(tree), _leaves(shs)))
    want += (8 // 2) * 4 * 2                    # tokens and pos on "data"
    assert out["decode"]["memory_analysis"]["argument_size_in_bytes"] == \
        want
    assert q["memory_analysis"]["argument_size_in_bytes"] < want


def _leaves(shs):
    out = []
    sharding.map_with_path(lambda _, s: out.append(s), shs)
    return out


def _vocab_replicated(monkeypatch):
    """The step as it ran before the vocabulary stayed split on the mesh:
    the table all-gathered before ``F.embedding``, the log-softmax on
    all-gathered float32 logits (DTensor's own strategies)."""
    def embedding(tokens, table, ax):
        return torch.nn.functional.embedding(
            tokens, common.replicate(table)).to(torch.bfloat16)

    def nll(logits, targets, ax):
        lp = torch.log_softmax(logits, dim=-1)
        hit = torch.arange(lp.shape[-1]) == targets[..., None]
        return -torch.sum(torch.where(hit, lp, 0.0), dim=-1)
    monkeypatch.setattr(model_mod, "_vocab_parallel_embedding", embedding)
    monkeypatch.setattr(model_mod, "_vocab_parallel_nll", nll)


def test_vocab_stays_split_as_in_the_reference_hlo(monkeypatch):
    """The reference's train step of qwen2-0.5b's smoke config (vocab 256
    split 2 ways) on the ``Auto`` (2, 2) mesh ``gloo_runs`` builds, 8 x 32
    tokens: GSPMD partitions the lookup and the log-softmax over the
    vocabulary, and the compiled HLO has no all-gather.  The port's fake
    (2, 2) trace of the same step gathers exactly the table (V x D
    bfloat16) and one rank's float32 logits (B/2 x (S - 1) x V) fewer
    bytes than the same trace with both replicated."""
    b, s = 8, 32
    ref_cfg = ref_configs.get_config("qwen2-0.5b", smoke=True)
    ref_model = RefLM(ref_cfg)
    opt_cfg = ref_opt.OptConfig(**torch_launch_dist.OPT)
    pipe = ref_data.Pipeline(ref_data.DataConfig(
        vocab=ref_cfg.vocab, global_batch=b, seq_len=s))
    params = ref_model.init(jax.random.PRNGKey(0))
    opt = ref_opt.init(params, opt_cfg)
    auto = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    with auto:
        params = jax.device_put(params,
                                ref_sharding.params_sharding(params, auto))
        batch = pipe.batch(0)
        batch = jax.device_put(batch, ref_sharding.batch_sharding(batch,
                                                                  auto))
        hlo = jax.jit(ref_train_step(ref_model, opt_cfg)).lower(
            params, opt, batch).compile().as_text()
    ref_kinds = ref_analysis.collective_bytes(hlo).bytes_by_kind
    assert ref_kinds["all-gather"] == 0 and ref_kinds["all-reduce"] > 0

    cfg = configs.get_config("qwen2-0.5b", smoke=True)

    def gathered():
        with dryrun.fake_group(4):
            return dryrun.trace_step(
                cfg, {"kind": "train", "seq": s, "batch": b}, _mesh((2, 2)),
                device="cpu")["collective_by_kind"]["all-gather"]
    split = gathered()
    _vocab_replicated(monkeypatch)
    whole = gathered()
    table = cfg.vocab * cfg.d_model * 2
    logits = b // 2 * (s - 1) * cfg.vocab * 4
    assert whole - split == table + logits


def test_dryrun_lower_cell_skips_and_reports():
    """``lower_cell`` skips what the reference skips, with its reason, and
    writes the reference's keys (``benchmarks/roofline_report.py`` reads
    ``status``, ``analytic_*``, ``collective_bytes``, ``chips`` and
    ``model_flops_6nd``)."""
    res = dryrun.lower_cell("qwen2-0.5b", "long_500k", device="cpu")
    assert res["status"] == "skipped"
    assert res["reason"] == ref_shapes.skip_reason(
        ref_configs.get_config("qwen2-0.5b"), "long_500k")


# ---------------------------------------------------------------------------
# training on a mesh
# ---------------------------------------------------------------------------
def test_one_rank_mesh_step_is_the_mesh_free_step():
    """Three AdamW steps of qwen2-0.5b's smoke config through a (1, 1)
    mesh on a one-rank gloo group equal the mesh-free steps bit for bit:
    losses, params and optimizer state (a one-rank DTensor runs the same
    local kernels)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    cfg = configs.get_config("qwen2-0.5b", smoke=True)
    model = LM(cfg, "cpu")
    opt_cfg = opt_mod.OptConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    pipe = data_mod.Pipeline(data_mod.DataConfig(global_batch=4, seq_len=16,
                                                 vocab=cfg.vocab),
                             device="cpu")
    step = make_train_step(model, opt_cfg)
    params = LM(cfg, "cpu").init(np.random.default_rng(0))
    opt = opt_mod.init(params, opt_cfg)

    def run(p, o, wrap=lambda b: b, ctx=None):
        losses = []
        for s in range(3):
            if ctx is None:
                p, o, m = step(p, o, wrap(pipe.batch(s)))
            else:
                with ctx():
                    p, o, m = step(p, o, wrap(pipe.batch(s)))
            losses.append(m["loss"])
        return p, o, losses

    p0, o0, l0 = run(params, opt)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_mesh(1, 1, device_type="cpu")
        ps = sharding.params_sharding(params, mesh)
        p1, o1, l1 = run(
            sharding.distribute(params, ps, mesh),
            sharding.distribute(opt, sharding.opt_sharding(opt, ps, mesh),
                                mesh),
            lambda b: sharding.distribute(
                b, sharding.batch_sharding(b, mesh), mesh),
            lambda: common.use_mesh(mesh))
        assert all(isinstance(x, DTensor) for x in tree_leaves(p1))
        full = [x.full_tensor() for x in tree_leaves((p1, o1))]
        parted = [i for i, (a, b) in enumerate(zip(
            tree_leaves((p0, o0)), full)) if not torch.equal(a, b)]
        assert parted == [], f"leaves {parted} part"
        assert [x.full_tensor().item() for x in l1] == \
            [x.item() for x in l0]
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def gloo_runs(tmp_path_factory):
    """qwen2-0.5b's smoke config from the JAX package's ``LM.init``
    weights: 10 steps on four gloo ranks as a (2, 2) mesh with a
    checkpoint after step 6, then two ranks re-launched as a (1, 2) mesh
    restoring it and continuing to step 10; and the JAX package's 10
    steps on its own (2, 2) mesh of conftest's 4 host devices.  That mesh
    has ``Auto`` axes, the GSPMD propagation the reference was written
    for: jax 0.9's ``make_mesh`` defaults to ``Explicit`` axes, under
    which the reference's vocab-sharded embedding gather raises
    ``ShardingTypeError`` (its own elastic test is marked slow)."""
    tmp = tmp_path_factory.mktemp("gloo")
    ref_cfg = ref_configs.get_config("qwen2-0.5b", smoke=True)
    ref_model = RefLM(ref_cfg)
    opt_cfg = ref_opt.OptConfig(**torch_launch_dist.OPT)
    ref_pipe = ref_data.Pipeline(ref_data.DataConfig(
        vocab=ref_cfg.vocab, **torch_launch_dist.DATA))
    params0 = ref_model.init(jax.random.PRNGKey(0))
    opt0 = ref_opt.init(params0, opt_cfg)
    auto = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    _, _, jax_losses = elastic_scenario.run_steps(
        auto, ref_model, params0, opt0, ref_pipe, opt_cfg,
        0, 10)

    port_params = params_from_numpy(jax.tree.map(np.asarray, params0),
                                    "cpu")
    port_opt = opt_mod.init(port_params,
                            opt_mod.OptConfig(**torch_launch_dist.OPT))
    ckpt.save(tmp / "init", 0, {"params": port_params, "opt": port_opt})
    _spawn(4, (2, 2), tmp / "init", 0, 0, 10, tmp / "a.json",
           tmp / "remesh", 6)
    _spawn(2, (1, 2), tmp / "remesh", 6, 6, 10, tmp / "b.json")
    return (jax_losses, json.loads((tmp / "a.json").read_text()),
            json.loads((tmp / "b.json").read_text()))


def test_gloo_mesh_training_matches_reference(gloo_runs):
    """Four gloo ranks on a (data=2, model=2) mesh, where the heads, the
    MLP and the vocab really split, take the JAX package's 10 steps on
    its (2, 2) mesh within the reference's re-mesh bound, 2e-2 a loss."""
    jax_losses, port_losses, _ = gloo_runs
    assert len(port_losses) == 10
    np.testing.assert_allclose(port_losses, jax_losses, rtol=0, atol=2e-2)
    assert np.mean(port_losses[-3:]) < np.mean(port_losses[:3])


def test_gloo_elastic_remesh_restores_and_continues(gloo_runs):
    """The counterpart of ``tests/elastic_scenario.py`` on real ranks:
    after a node loss the run re-launches on a (1, 2) mesh, restores the
    step-6 checkpoint (full tensors, re-split by the rules) and continues
    to step 10 within 2e-2 a loss of the uninterrupted run."""
    _, port_losses, remeshed = gloo_runs
    assert len(remeshed) == 4
    np.testing.assert_allclose(remeshed, port_losses[6:], rtol=0, atol=2e-2)


@pytest.fixture(scope="module")
def vocab_runs(tmp_path_factory):
    """``torch_launch_dist.vocab_main`` on four gloo ranks as a (2, 2)
    mesh: each rank's loss, logit gradient, lookup and table gradient
    through the vocab-parallel functions."""
    out = tmp_path_factory.mktemp("vocab") / "rank"
    _spawn(4, (2, 2), out, target=torch_launch_dist.vocab_main)
    return [json.loads(Path(f"{out}.{r}").read_text()) for r in range(4)]


def test_vocab_parallel_loss_matches_log_softmax(vocab_runs):
    """The vocab-parallel NLL's mean and its logit gradient against
    ``torch.log_softmax`` on the whole float32 logits: only the order of
    the float32 sums differs, so the loss agrees within rtol 1e-5 and
    each logit's gradient within 1e-5 of the largest |g|, on every
    rank."""
    x = torch_launch_dist.vocab_inputs()
    logits = torch.from_numpy(x["logits"]).requires_grad_()
    lp = torch.log_softmax(logits, dim=-1)
    loss = -torch.take_along_dim(
        lp, torch.from_numpy(x["targets"])[..., None], -1).mean()
    loss.backward()
    g = logits.grad.numpy()
    for r in vocab_runs:
        np.testing.assert_allclose(r["loss"], loss.item(), rtol=1e-5, atol=0)
        assert np.abs(np.array(r["logit_grad"]) - g).max() \
            <= 1e-5 * np.abs(g).max(), r["rank"]


def test_vocab_parallel_lookup_is_the_plain_lookup(vocab_runs):
    """The vocab-parallel lookup equals ``F.embedding`` on the whole table
    bit for bit (one rank holds each row, the others add zeros).  Its
    table gradient stays on its ranks: each rank's shard equals
    ``F.embedding``'s gradient from that rank's half of the batch, rows
    for rows, left ``Partial`` on "data" and split on "model"; summed
    over "data" it is the sum of the two halves' gradients."""
    x = torch_launch_dist.vocab_inputs()
    table = torch.from_numpy(x["table"]).to(torch.bfloat16)
    tokens = torch.from_numpy(x["tokens"]).long()
    grad = torch.from_numpy(x["grad"]).to(torch.bfloat16)
    want = torch.nn.functional.embedding(tokens, table)
    halves = []
    for d in range(2):
        t = table.clone().requires_grad_()
        rows = slice(2 * d, 2 * d + 2)
        torch.nn.functional.embedding(tokens[rows], t).backward(grad[rows])
        halves.append(t.grad)
    per_rank = table.shape[0] // 2

    def bf16(v):
        return torch.tensor(v).to(torch.bfloat16)
    for r in vocab_runs:
        d, m = r["coords"]
        assert torch.equal(bf16(r["lookup"]), want)
        assert r["lookup_placements"] == ["S(0)", "R"]
        assert r["table_grad_placements"] == ["P(sum)", "S(0)"]
        assert torch.equal(bf16(r["table_grad_local"]),
                           halves[d][m * per_rank:(m + 1) * per_rank])
        assert torch.equal(bf16(r["table_grad_full"]), halves[0] + halves[1])


# ---------------------------------------------------------------------------
# entry points and imports
# ---------------------------------------------------------------------------
def test_launch_entry_points_default_to_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_train.main(["--arch", "qwen2-0.5b", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun.main(["--arch", "qwen2-0.5b", "--shape", "decode_32k",
                     "--out", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun.lower_cell("qwen2-0.5b", "decode_32k")
    assert list(tmp_path.iterdir()) == []


def test_launch_modules_import_neither_jax_nor_repro():
    for path in sorted((ROOT / "src/repro_torch/launch").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in ("jax", "jaxlib", "repro"), \
                    (path.name, n)


def test_smoke_launch_phase_on_the_cpu():
    """``chip_smoke.phase_launch`` on the CPU at smoke widths: the
    production decode cell on the fake 256-rank mesh; the one-card
    estimate falling back from a batch of 16 to 8 on a budget that 16
    misses, its argument bytes and FLOPs equal to the real step's
    through a one-rank gloo mesh; the entry point's 4 steps on a mesh
    within the train bound of the mesh-free steps, bit for bit; no
    kernel launched."""
    cfg = configs.get_config("qwen2-0.5b", smoke=True)
    sh = {"kind": "decode", "seq": 64, "batch": 16}
    with dryrun.fake_group(1):
        est = dryrun.trace_step(cfg, sh, make_mesh(1, 1, device_type="cpu"),
                                device="cpu")["memory_analysis"]
    budget = est["argument_size_in_bytes"] + est["temp_size_in_bytes"]
    res = chip_smoke.phase_launch(
        0, dev="cpu", cfg=cfg, cells=(("decode_32k", False),), seq=64,
        batches=(16, 8), mem_bytes=budget, train_batch=2, train_seq=16,
        launch_args=("--device", "cpu"))
    assert [p["chips"] for p in res["production"]] == [256]
    card = res["card"]
    assert card["batch"] == 8 and len(card["estimates"]) == 2
    assert card["argument_bytes"][0] == card["argument_bytes"][1]
    assert card["counted_flops"][0] == card["counted_flops"][1] > 0
    train = res["train"]
    assert train["final_state_bit_identical"]
    assert train["last_loss_bit_identical"]
    before, after = res["kernel_launches"]
    assert before == after
