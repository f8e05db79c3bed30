"""Port parity, networks and weights: allocnet_tpu_torch's ConvLSTMAllocNet
with parameters read by its own msgpack reader against the JAX net.apply
on the shipped nets and the runs/big4 flagship checkpoint (CPU, f32), and
its ConvMLPAllocNet against the JAX ConvMLPAllocNet from flax-initialized
parameters (no MLP checkpoint ships)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from allocnet_tpu.models import import_torch
from allocnet_tpu.models.networks import ConvLSTMAllocNet as JConvLSTMAllocNet
from allocnet_tpu.models.networks import ConvMLPAllocNet as JConvMLPAllocNet
from allocnet_tpu_torch.config import QPConfig
from allocnet_tpu_torch.models import packing, weights
from allocnet_tpu_torch.models.networks import ConvLSTMAllocNet, ConvMLPAllocNet
from allocnet_tpu_torch.utils import scenarios
from tests.torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (file, seq_len, stop-token threshold): imported reference nets stop at
# 0.5 (README, reference parity notes), the flagship at its trained 0.42
NETS = [("data/params/seq5_tokenthresh0_35.msgpack", 5, 0.5),
        ("data/params/seq5_tokenthresh0_35_cpu.msgpack", 5, 0.5),
        ("data/params/seq5_rest2rest.msgpack", 5, 0.5),
        ("data/params/seq10_rest2rest.msgpack", 10, 0.5),
        ("runs/big4/checkpoints/checkpoint24605.msgpack", 5, 0.42)]


def _tree_equal(a, b, path=""):
    if isinstance(b, dict):
        assert isinstance(a, dict) and a.keys() == b.keys(), path
        for k in b:
            _tree_equal(a[k], b[k], f"{path}/{k}")
    else:
        assert isinstance(a, np.ndarray), path
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)


@pytest.mark.parametrize("path,seq,thresh", NETS)
def test_msgpack_reader_matches_flax(path, seq, thresh):
    with open(os.path.join(ROOT, path), "rb") as f:
        want = serialization.msgpack_restore(f.read())
    _tree_equal(weights.read_msgpack(os.path.join(ROOT, path)), want)


def test_msgpack_reader_scalars_and_containers(tmp_path):
    """The types the reader handles beyond what the shipped files use."""
    tree = {"a": np.arange(6, dtype=np.int64).reshape(2, 3),
            "b": {"c": np.full((), 2.5, np.float32),
                  "d": np.zeros((0, 4), np.float64)},
            "e": np.ones((300,), np.float16)}
    p = tmp_path / "t.msgpack"
    p.write_bytes(serialization.msgpack_serialize(tree))
    _tree_equal(weights.read_msgpack(str(p)), tree)
    r = weights._Reader(bytes([0x93, 0x01, 0xff, 0xcb]) + np.float64(1.5).byteswap().tobytes())
    assert r.value() == [1, -1, 1.5]
    with pytest.raises(ValueError):
        weights._Reader(bytes([0xc1])).value()
    with pytest.raises(ValueError):           # flax's numpy-scalar ext type
        weights._Reader(bytes([0xd4, 0x03, 0x00])).value()


def test_state_dict_names_are_the_reference_names():
    net = ConvLSTMAllocNet()
    assert set(net.state_dict()) == set(import_torch._LSTM_MAP)
    assert set(weights.JAX_TO_TORCH.values()) == set(import_torch._LSTM_MAP)
    for tkey, jpath in import_torch._LSTM_MAP.items():
        assert weights.JAX_TO_TORCH[jpath] == tkey


@pytest.mark.parametrize("path,seq,thresh", NETS)
def test_network_matches_jax(path, seq, thresh):
    full = os.path.join(ROOT, path)
    jparams = import_torch.load_params_msgpack(full)
    if "params" in jparams and "w_ih" not in jparams["params"]:
        jparams = jparams["params"]            # training checkpoint
    jnet = JConvLSTMAllocNet(seq_len=seq, hidden_size=256, token_thresh=thresh)
    net = ConvLSTMAllocNet(seq, 256, thresh)
    net.load_state_dict(weights.load_params(full))

    sc = scenarios.random_scenarios(QPConfig(max_seg=seq), 16, seed=4,
                                    min_seg=1)
    outs = {}
    for name, jdt, tdt in (("f64", jnp.float64, torch.float64),
                           ("f32", jnp.float32, torch.float32)):
        st = sc.state.astype(jdt)
        hp = sc.hpolys.astype(jdt)
        jp = jax.tree.map(lambda a: jnp.asarray(a, jdt), jparams)
        jt, jk = jnet.apply(jp, jnp.asarray(st).reshape(16, 2, 9).transpose(0, 2, 1),
                            jnp.transpose(jnp.asarray(hp), (0, 2, 3, 1)))
        with torch.no_grad():
            t, k = net.to(tdt)(packing.pack_state(torch.tensor(st)),
                               packing.pack_hpolys(torch.tensor(hp)))
        assert t.dtype == tdt and np.asarray(jt).dtype == jdt
        outs[name] = (t.numpy(), k.numpy(), np.asarray(jt), np.asarray(jk))
    t64, k64, jt64, jk64 = outs["f64"]
    # f64 on both sides, the same layer math: agreement to rounding (the
    # masked zeros are exact zeros on both)
    np.testing.assert_allclose(t64, jt64, rtol=1e-12, atol=0)
    np.testing.assert_allclose(k64, jk64, rtol=1e-12, atol=0)
    # f32 on each side against the f64 result: f32 sums over the 256-wide
    # LSTM gates, reordered by thread count and library across 5-10 steps,
    # reach ~2e-5 relative; rtol 1e-4 (+1e-6 absolute for near-zero outputs)
    for t32, k32 in (outs["f32"][:2], outs["f32"][2:]):
        np.testing.assert_allclose(t32, t64, rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(k32, k64, rtol=1e-4, atol=1e-6)
    assert t64.shape == (16, seq)


def test_packing_roundtrip():
    g = torch.Generator().manual_seed(0)
    st = torch.randn((3, 2, 3, 3), generator=g)
    hp = torch.randn((3, 5, 50, 4), generator=g)
    assert torch.equal(packing.unpack_state(packing.pack_state(st)), st)
    assert torch.equal(packing.unpack_hpolys(packing.pack_hpolys(hp)), hp)
    # row 1 of the stacked state is the start velocity x
    assert torch.equal(packing.pack_state(st)[:, 1, 0], st[:, 0, 0, 1])


def test_from_jax_params_rejects_foreign_tree():
    with pytest.raises(KeyError):
        weights.from_jax_params({"params": {"dense": np.zeros(3)}})


def _mlp_pair(seq, hidden, seed):
    jnet = JConvMLPAllocNet(seg=5, seq_len=seq, hidden_size=hidden)
    sc = scenarios.random_scenarios(QPConfig(max_seg=seq), 16, seed=seed,
                                    min_seg=1)
    st = jnp.asarray(sc.state).reshape(16, 2, 9).transpose(0, 2, 1)
    hp = jnp.transpose(jnp.asarray(sc.hpolys), (0, 2, 3, 1))
    jparams = jnet.init(jax.random.PRNGKey(seed), st, hp)
    jparams = jax.tree.map(lambda a: np.asarray(a, np.float32), jparams)
    net = ConvMLPAllocNet(seg=5, seq_len=seq, hidden_size=hidden)
    net.load_state_dict(weights.from_jax_params(jparams))
    return jnet, jparams, net, sc


@pytest.mark.parametrize("seq,hidden", [(5, 32), (10, 128)])
def test_mlp_matches_jax(seq, hidden):
    jnet, jparams, net, sc = _mlp_pair(seq, hidden, seed=6)
    outs = {}
    for name, jdt, tdt in (("f64", jnp.float64, torch.float64),
                           ("f32", jnp.float32, torch.float32)):
        st = sc.state.astype(jdt)
        hp = sc.hpolys.astype(jdt)
        jp = jax.tree.map(lambda a: jnp.asarray(a, jdt), jparams)
        jt = jnet.apply(jp, jnp.asarray(st).reshape(16, 2, 9).transpose(0, 2, 1),
                        jnp.transpose(jnp.asarray(hp), (0, 2, 3, 1)))
        with torch.no_grad():
            t = net.to(tdt)(packing.pack_state(torch.tensor(st)),
                            packing.pack_hpolys(torch.tensor(hp)))
        assert t.dtype == tdt and t.shape == (16, 5)
        outs[name] = (t.numpy(), np.asarray(jt))
    t64, jt64 = outs["f64"]
    # f64, the same layer math (LayerNorm in another summation order):
    # agreement to rounding
    np.testing.assert_allclose(t64, jt64, rtol=1e-12, atol=0)
    # f32 against the f64 result: sums over <= 128 terms and two
    # LayerNorms, ~1e-6 relative; rtol 1e-4 as the ConvLSTM's
    for t32 in outs["f32"]:
        np.testing.assert_allclose(t32, t64, rtol=1e-4, atol=1e-6)
    assert (t64 > 0).all()


def test_mlp_dropout_only_when_asked():
    """The JAX training step never passes deterministic=False, so the MLP
    trains without dropout: train() mode must not turn it on."""
    _, _, net, sc = _mlp_pair(5, 32, seed=7)
    st = packing.pack_state(torch.tensor(sc.state, dtype=torch.float32))
    hp = packing.pack_hpolys(torch.tensor(sc.hpolys, dtype=torch.float32))
    with torch.no_grad():
        want = net.eval()(st, hp)
        assert torch.equal(net.train()(st, hp), want)
        torch.manual_seed(0)
        assert not torch.equal(net(st, hp, deterministic=False), want)


def test_mlp_init_and_names():
    net = ConvMLPAllocNet()
    assert torch.equal(net.output_module[8].bias, torch.ones(5))
    assert set(net.state_dict()) == set(weights.MLP_JAX_TO_TORCH.values())
    jnet = JConvMLPAllocNet()
    jp = jnet.init(jax.random.PRNGKey(0), jnp.zeros((1, 9, 2)),
                   jnp.zeros((1, 50, 4, 5)))
    leaves = {tuple(k.key for k in path)[1:]
              for path, _ in jax.tree_util.tree_leaves_with_path(jp)}
    assert leaves == set(weights.MLP_JAX_TO_TORCH)
    np.testing.assert_array_equal(np.asarray(jp["params"]["l3_b"]), 1.0)
