"""Port parity, the deploy artefacts: models/export (TorchScript net, the
exported replanning step) and models/import_torch (TorchScript and msgpack
checkpoints) against allocnet_tpu's on the CPU.

Tolerances: the TorchScript module runs the eager net's ops (exact); the
JAX net on the params read back from the port's model.pt against the
port's net, 1e-5 (f32 through two frameworks' kernels); the msgpack
files are compared byte for byte; the exported replan program against the
eager `replan_step`, 1e-6 of the largest coefficient (the same ops), and
against the JAX `replan_step`, the same flags and coefficients to 1e-3 of
the largest (the f32 solve's bar)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from allocnet_tpu.config import AllocNetConfig as JAllocNetConfig
from allocnet_tpu.config import QPConfig as JQPConfig
from allocnet_tpu.config import SolverConfig as JSolverConfig
from allocnet_tpu.models import import_torch as jimport
from allocnet_tpu.models.networks import ConvLSTMAllocNet as JConvLSTM
from allocnet_tpu.planner import replan as jreplan
from allocnet_tpu_torch.config import AllocNetConfig, QPConfig, SolverConfig
from allocnet_tpu_torch.models import export, import_torch, weights
from allocnet_tpu_torch.models.networks import ConvLSTMAllocNet, ConvMLPAllocNet
from allocnet_tpu_torch.ops import admm_chunk
from allocnet_tpu_torch.planner import replan
from allocnet_tpu_torch.utils import scenarios
from tests.torch_threads import one_torch_thread  # noqa: F401

NET_TOL = 1e-5
PROGRAM_TOL = 1e-6
JAX_COEF_TOL = 1e-3


def _net(seq_len: int, seed: int = 0):
    torch.manual_seed(seed)
    return ConvLSTMAllocNet(seq_len, 16, token_thresh=0.42).eval()


def _inputs(seq_len: int, batch: int = 3, seed: int = 1):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(batch, 9, 2)).astype(np.float32),
            rng.normal(size=(batch, 50, 4, seq_len)).astype(np.float32))


@pytest.mark.parametrize("seq_len", [5, 10])
def test_torchscript_roundtrip(tmp_path, seq_len):
    net = _net(seq_len)
    path = export.save(str(tmp_path), net, batch=3, seq_len=seq_len)
    assert path.endswith("model.pt") and os.path.getsize(path) > 10_000
    loaded = export.load(str(tmp_path), device="cpu")
    assert set(loaded.state_dict()) == set(net.state_dict())
    for batch in (3, 1):
        x, h = (torch.from_numpy(a) for a in _inputs(seq_len, batch))
        with torch.no_grad():
            got, want = loaded(x, h), net(x, h)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("seq_len", [5, 10])
def test_jax_reads_port_torchscript(tmp_path, seq_len):
    """The JAX package's own reader takes the port's model.pt, and the
    JAX net on those params equals the port's net."""
    net = _net(seq_len, seed=3)
    path = export.save(str(tmp_path), net, batch=1, seq_len=seq_len)
    assert jimport.seq_len_of_checkpoint(path) == seq_len
    assert import_torch.seq_len_of_checkpoint(path) == seq_len
    jparams = jimport.load_torchscript_lstm(path)
    jnet = JConvLSTM(seq_len=seq_len, hidden_size=16, token_thresh=0.42)
    x, h = _inputs(seq_len, seed=4)
    jt, jk = jnet.apply(jax.tree.map(lambda a: jnp.asarray(a, jnp.float32),
                                     jparams),
                        jnp.asarray(x, jnp.float32), jnp.asarray(h, jnp.float32))
    with torch.no_grad():
        t, k = net(torch.from_numpy(x), torch.from_numpy(h))
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), atol=NET_TOL)
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), atol=NET_TOL)
    sd = import_torch.load_params(path)
    assert all(torch.equal(sd[k_], v) for k_, v in net.state_dict().items())
    assert os.listdir(tmp_path) == ["model.pt"]        # no cache written


def test_msgpack_writer_matches_flax(tmp_path):
    """The port's writer gives the bytes flax writes; the JAX reader and
    the port's reader give back the same arrays, bit for bit."""
    src = os.path.join("data", "params", "seq5_tokenthresh0_35.msgpack")
    sd = weights.load_params(src)
    path = str(tmp_path / "params.msgpack")
    import_torch.save_params_msgpack(sd, path)
    raw = open(path, "rb").read()
    assert raw == serialization.msgpack_serialize(weights.to_jax_params(sd))
    assert raw == open(src, "rb").read()
    jtree = jimport.load_params_msgpack(path)
    want = weights.to_jax_params(sd)
    for path_, key in weights.JAX_TO_TORCH.items():
        a, b = jtree["params"], want["params"]
        for p in path_:
            a, b = a[p], b[p]
        assert a.dtype == b.dtype and np.array_equal(a, b), key
    back = import_torch.load_params(path)
    assert all(torch.equal(back[k], v) for k, v in sd.items())
    mlp = {k: torch.randn(v.shape)
           for k, v in ConvMLPAllocNet().state_dict().items()}
    import_torch.save_params_msgpack(mlp, path)
    back = weights.load_params(path)
    assert all(torch.equal(back[k], v) for k, v in mlp.items())


@pytest.fixture(scope="module")
def replan_setup(tmp_path_factory):
    """tests/test_aux.py's replan-export configuration (res 5, 1 x 30,
    hidden 16): a JAX net's params, the port's net on them, one scenario,
    and the port's program exported and loaded on the CPU."""
    cfg = AllocNetConfig(qp=QPConfig(res=5),
                         solver=SolverConfig(n_chunks=1, iters_per_chunk=30))
    jcfg = JAllocNetConfig(qp=JQPConfig(res=5),
                           solver=JSolverConfig(n_chunks=1, iters_per_chunk=30))
    jnet = JConvLSTM(seq_len=5, hidden_size=16, token_thresh=0.42)
    jparams = jnet.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, 9, 2), jnp.float32),
                        jnp.zeros((1, 50, 4, 5), jnp.float32))
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), jparams)
    # a time head that starts at ~2 s per segment and stop tokens that do
    # not fire early, so that the plans solve and the coefficients
    # compared are a solution's
    jparams = {"params": dict(jparams["params"],
                              tf_b=jnp.full((1,), 2.0, jnp.float32),
                              stop_b=jnp.full((1,), -5.0, jnp.float32))}
    net = ConvLSTMAllocNet(5, 16, token_thresh=0.42)
    net.load_state_dict(weights.from_jax_params(
        jax.tree.map(np.asarray, jparams)))
    path = str(tmp_path_factory.mktemp("replan"))
    export.save_replan(path, net, cfg, batch=1, device="cpu")
    return cfg, jcfg, net, jnet, jparams, export.load_replan(path), path


def test_replan_export_matches_eager_and_jax(replan_setup):
    cfg, jcfg, net, jnet, jparams, program, path = replan_setup
    assert os.path.getsize(os.path.join(path, "replan.pt2")) > 10_000
    sc = scenarios.random_scenarios(cfg.qp, 1, seed=91, min_seg=2)
    f32 = np.float32
    st, hp = sc.state.astype(f32), sc.hpolys.astype(f32)
    seg = sc.seg.astype(np.int32)
    prev = replan.init_state(1, cfg, device="cpu")
    args = (torch.from_numpy(st), torch.from_numpy(hp), torch.from_numpy(seg),
            prev.coeffs, prev.have_prev)
    out = program(*args)
    eager = replan.replan_step(net, None, cfg, *args[:3], prev, device="cpu")
    assert all(not t.requires_grad for t in out)
    c_scale = max(1.0, float(eager[1].abs().max()))
    np.testing.assert_array_equal(out[2].numpy(), eager[2].numpy())
    assert float((out[1] - eager[1]).abs().max()) <= PROGRAM_TOL * c_scale
    assert float((out[0] - eager[0]).abs().max()) <= PROGRAM_TOL
    np.testing.assert_array_equal(out[4].numpy(), eager[3].have_prev.numpy())
    assert float((out[3] - eager[3].coeffs).abs().max()) <= PROGRAM_TOL * c_scale

    jprev = jreplan.init_state(1, jcfg)
    jt, jc, js, _ = jreplan.replan_step(
        jnet, jparams, jcfg, jnp.asarray(st), jnp.asarray(hp),
        jnp.asarray(seg), jreplan.ReplanState(
            jnp.asarray(jprev.coeffs, jnp.float32), jprev.have_prev))
    assert bool(out[2][0])
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(js))
    np.testing.assert_allclose(out[0].numpy(), np.asarray(jt), atol=NET_TOL)
    jc = np.asarray(jc)
    assert np.abs(out[1].numpy() - jc).max() <= JAX_COEF_TOL * max(
        1.0, np.abs(jc).max())

    # a second step warm-started from the first, through the program
    out2 = program(*args[:3], out[3], out[4])
    eager2 = replan.replan_step(net, None, cfg, *args[:3],
                                replan.ReplanState(out[3], out[4]),
                                device="cpu")
    np.testing.assert_array_equal(out2[2].numpy(), eager2[2].numpy())
    assert float((out2[1] - eager2[1]).abs().max()) <= PROGRAM_TOL * max(
        1.0, float(eager2[1].abs().max()))


def test_exported_program_calls_the_kernel_operator(replan_setup):
    """The program holds the admm_chunk and LDL block operators (a real
    launch on a card; the plain version on the CPU)."""
    *_, program, _ = replan_setup
    nodes = [n for m in program.modules()
             if isinstance(m, torch.fx.GraphModule) for n in m.graph.nodes]
    targets = {str(n.target) for n in nodes}
    assert "allocnet_torch.admm_chunk.default" in targets
    assert "allocnet_torch.ldl_block.default" in targets
    # one node per diagonal block of the polish's LDL^T, not ~20 per
    # column: the program stays small enough to export and load quickly
    assert len(nodes) < 20_000
    assert admm_chunk.admm_chunk.launches == 0     # no card here
