"""The port's reader of the JAX package's orbax checkpoints, on the CPU.

The card's machine has no orbax, tensorstore or zstandard, so the port reads
a JAX checkpoint by hand: ``training/zstd.py`` (a zstd decoder),
``training/ocdbt.py`` (the OCDBT store), ``training/_orbax.py`` (the
zarr v2 tree) and ``training/checkpoint.py::restore_checkpoint``. Each is
held against the library it stands in for, here where those are installed:

- zstd: ``zstandard``'s frames of seeded float32 arrays, text, zeros,
  incompressible bytes and sizes across the 128 KiB block edge, at levels 1,
  3 and 19, with and without a content checksum, decode to the input byte
  for byte; so do concatenated and skippable frames. XXH64 and CRC-32C
  against known vectors and the ``xxhash`` / ``google_crc32c`` modules;
- OCDBT: the keys and values of checkpoints the JAX ``save_checkpoint``
  writes in ``tmp_path``, and of a store with interior B+tree nodes and
  values in data files, equal tensorstore's ``ocdbt`` driver's; a flipped
  byte or a truncated file raises naming the file;
- the tree: every leaf of the full and reference layouts bitwise orbax's
  own restore, in float32 and float64, and an array orbax split into
  chunks (sharded over the CPU devices) and a zarr array with absent chunks
  (filled) read whole;
- ``restore_checkpoint``: the port's state (params through the
  ``params_from_numpy`` layout, the Adam moments and step, the normalizer,
  ``env_steps``) bitwise the orbax restore; one learner step from the
  restored state matches optax's step from the same checkpoint at the PPO
  parity tolerance (rtol 1e-7, atol 1e-8, tests/test_torch_ppo_train.py);
  ``train()`` resumes from an orbax directory at its ``env_steps``, and
  from the reference layout with the optimizer and ``env_steps`` restarted;
- the committed fixtures (``assets/jax_checkpoints/``, written by
  ``scripts/make_jax_checkpoint_fixture.py``) equal a fresh orbax restore
  and their ``.npz``.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import tensorstore as ts
import torch
import xxhash
import zstandard
from orbax import checkpoint as ocp

from brax_tracking_tpu.agents.ppo import losses as jlosses
from brax_tracking_tpu.agents.ppo import networks as jnetworks
from brax_tracking_tpu.agents.ppo import train as jtrain
from brax_tracking_tpu.training import checkpoint as jcheckpoint
from brax_tracking_tpu.training import gradients as jgradients
from brax_tracking_tpu.training import running_statistics as jrs
from brax_tracking_tpu.training import types as jtypes
from brax_tracking_tpu_torch.agents.ppo import losses as tlosses
from brax_tracking_tpu_torch.agents.ppo import networks as tnetworks
from brax_tracking_tpu_torch.agents.ppo import train as ttrain
from brax_tracking_tpu_torch.training import _orbax, ocdbt, zstd
from brax_tracking_tpu_torch.training import checkpoint as tcheckpoint
from brax_tracking_tpu_torch.training import gradients as tgradients
from brax_tracking_tpu_torch.training import running_statistics as trs
from brax_tracking_tpu_torch.training.types import Transition
from test_torch_ppo_train import PM_ARGS, PointMass

RTOL, ATOL = 1e-7, 1e-8
OBS, ACT, HIDDEN, LR, ENV_STEPS = 6, 2, (16, 16), 3e-4, 512
LOSS_HPARAMS = dict(entropy_cost=1e-3, discounting=0.99, reward_scaling=1.0, gae_lambda=0.95,
                    clipping_epsilon=0.3, normalize_advantage=True)
FIXTURES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "brax_tracking_tpu_torch", "assets", "jax_checkpoints")

# --- zstd ----------------------------------------------------------------------

_rng = np.random.default_rng(17)
ZSTD_DATA = {
    "float32": (_rng.standard_normal(60000) * 0.05).astype(np.float32).tobytes(),
    "text": b"".join(b"step %d reward %.4f done %d\n" % (i, np.sin(i), i % 7 == 0)
                     for i in range(6000)),
    "zeros": bytes(200000),
    "random": _rng.integers(0, 256, 70000, dtype=np.uint8).tobytes(),
    "block_edge": _rng.integers(0, 5, (1 << 17) + 1, dtype=np.uint8).tobytes(),
    "below_edge": _rng.integers(0, 5, (1 << 17) - 1, dtype=np.uint8).tobytes(),
    "tiny": b"x",
    "empty": b"",
}


@pytest.mark.parametrize("checksum", [False, True], ids=["plain", "checksum"])
@pytest.mark.parametrize("level", [1, 3, 19])
@pytest.mark.parametrize("kind", list(ZSTD_DATA))
def test_zstd_matches_zstandard(kind, level, checksum):
    data = ZSTD_DATA[kind]
    frame = zstandard.ZstdCompressor(level=level, write_checksum=checksum).compress(data)
    assert zstd.decompress(frame) == data


def test_zstd_frames_in_a_row_and_skippable_frames():
    a, b = ZSTD_DATA["text"], ZSTD_DATA["float32"]
    skip = (0x184D2A53).to_bytes(4, "little") + (5).to_bytes(4, "little") + b"abcde"
    frames = (zstandard.ZstdCompressor(level=3).compress(a) + skip
              + zstandard.ZstdCompressor(level=1, write_checksum=True).compress(b))
    assert zstd.decompress(frames) == a + b
    # a streamed frame: no content size in its header, several blocks
    streamed = zstandard.ZstdCompressor(level=1, write_content_size=False).compressobj()
    frame = streamed.compress(ZSTD_DATA["block_edge"]) + streamed.flush()
    assert zstd.decompress(frame) == ZSTD_DATA["block_edge"]


def test_zstd_raises_on_a_bad_checksum_a_dictionary_and_garbage():
    frame = bytearray(zstandard.ZstdCompressor(level=3, write_checksum=True).compress(
        ZSTD_DATA["text"]))
    frame[-1] ^= 1
    with pytest.raises(zstd.ZstdError, match="checksum"):
        zstd.decompress(bytes(frame))
    samples = [b"step %d reward %.3f done %d" % (i, i / 7, i % 3) for i in range(2000)]
    d = zstandard.train_dictionary(2048, samples)
    assert d.dict_id()
    with pytest.raises(zstd.ZstdError, match="dictionary"):
        zstd.decompress(zstandard.ZstdCompressor(dict_data=d).compress(samples[5]))
    with pytest.raises(zstd.ZstdError, match="not a zstd frame"):
        zstd.decompress(b"\x00" * 16)
    with pytest.raises(zstd.ZstdError):
        zstd.decompress(zstandard.ZstdCompressor(level=3).compress(ZSTD_DATA["text"])[:-9])


@pytest.mark.parametrize("data", [b"", b"a", b"abc", b"123456789", bytes(range(256)) * 9,
                                  ZSTD_DATA["float32"][:1001]])
def test_xxh64_and_crc32c(data):
    import google_crc32c

    assert zstd.xxh64(data) == xxhash.xxh64(data).intdigest()
    assert zstd.xxh64(data, 12345) == xxhash.xxh64(data, seed=12345).intdigest()
    assert ocdbt.crc32c(data) == int.from_bytes(google_crc32c.Checksum(data).digest(), "big")


def test_known_vectors():
    assert zstd.xxh64(b"") == 0xEF46DB3751D8E999
    assert ocdbt.crc32c(b"123456789") == 0xE3069283


# --- checkpoints of the JAX package --------------------------------------------------


def _jax_state(dtype, seed=0, obs=OBS, act=ACT, hidden=HIDDEN):
    """A JAX TrainingState with non-zero Adam moments and count, a normalizer
    from a seeded batch and env_steps > 0."""
    params = jlosses.PPONetworkParams(
        policy=jnetworks.init_mlp(jax.random.PRNGKey(seed + 1), hidden + (2 * act,), obs, dtype),
        value=jnetworks.init_mlp(jax.random.PRNGKey(seed + 2), hidden + (1,), obs, dtype))
    opt = optax.adam(LR)
    state = opt.init(params)
    key = jax.random.PRNGKey(seed + 3)
    for _ in range(2):
        leaves, treedef = jax.tree_util.tree_flatten(params)
        keys = jax.random.split(key, len(leaves) + 1)
        key = keys[0]
        grads = jax.tree_util.tree_unflatten(
            treedef, [jax.random.normal(k, x.shape, dtype) for k, x in zip(keys[1:], leaves)])
        updates, state = opt.update(grads, state)
        params = optax.apply_updates(params, updates)
    normalizer = jrs.update(jrs.init_state(jnp.zeros((obs,), dtype)),
                            1.0 + jax.random.normal(jax.random.PRNGKey(seed + 4), (32, obs), dtype))
    step_dtype = jnp.int64 if jax.config.jax_enable_x64 else jnp.int32
    return jtrain.TrainingState(optimizer_state=state, params=params,
                                normalizer_params=normalizer,
                                env_steps=jnp.asarray(ENV_STEPS, step_dtype))


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """{(layout, dtype name): directory} written by the JAX save_checkpoint."""
    root = tmp_path_factory.mktemp("orbax")
    out = {}
    for dtype in (jnp.float32, jnp.float64):
        st = _jax_state(dtype)
        name = jnp.dtype(dtype).name
        out["full", name] = str(root / f"full_{name}")
        jcheckpoint.save_checkpoint(out["full", name], st)
        out["reference", name] = str(root / f"reference_{name}")
        jcheckpoint.save_checkpoint(out["reference", name], (st.normalizer_params, st.params))
    return out


CASES = [(layout, dt) for layout in ("full", "reference") for dt in ("float32", "float64")]


def _ts_store(path):
    return ts.KvStore.open({"driver": "ocdbt", "base": f"file://{path}/"}).result()


@pytest.mark.parametrize("layout,dt", CASES)
def test_ocdbt_keys_and_bytes_match_tensorstore(saved, layout, dt):
    path = saved[layout, dt]
    ref = _ts_store(path)
    keys = sorted(k.decode() for k in ref.list().result())
    store = ocdbt.OcdbtStore(path)
    assert store.list() == keys
    for k in keys:
        assert store.read(k) == ref[k], k


def test_ocdbt_interior_nodes_and_indirect_values(tmp_path):
    """Small nodes force a B+tree of several levels; values above the inline
    limit go to data files."""
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{tmp_path}/",
                          "config": {"max_decoded_node_bytes": 256,
                                     "max_inline_value_bytes": 8}}).result()
    rng = np.random.default_rng(3)
    for i in range(80):
        kv[f"tree/{'ab'[i % 2]}.{i:03d}/leaf"] = rng.bytes(int(rng.integers(1, 60)))
    ref = _ts_store(tmp_path)
    store = ocdbt.OcdbtStore(str(tmp_path))
    keys = sorted(k.decode() for k in ref.list().result())
    assert store.list() == keys and len(keys) == 80
    assert store._root[1] > 1  # the root is an interior node of height > 1
    for k in keys:
        assert store.read(k) == ref[k], k


def _read_files(path):
    """The files a restore reads: the root manifest and B+tree node, and
    each data file holding values, with the end of its last value read."""
    root = [os.path.join(path, "manifest.ocdbt")] + [
        os.path.join(path, "d", f) for f in os.listdir(os.path.join(path, "d"))]
    ends = {}
    for ref in ocdbt.OcdbtStore(path)._index().values():
        if not isinstance(ref, bytes):
            name = os.path.join(path, ref[0])
            ends[name] = max(ends.get(name, 0), ref[1] + ref[2])
    return root, ends


@pytest.mark.parametrize("damage", ["flip", "truncate"])
def test_ocdbt_corrupt_or_torn_file_raises(saved, tmp_path, damage):
    """A flipped byte in a manifest or node (each carries a CRC-32C) or a
    truncated file raises naming the file. The values themselves carry no
    checksum in the format (orbax writes zstd frames without one), so a
    value file is only cut, by a byte inside its last value, here."""
    import shutil

    src = saved["full", "float64"]
    nodes, values = _read_files(src)
    assert len(nodes) == 2 and values
    for f in nodes + (list(values) if damage == "truncate" else []):
        shutil.copytree(src, tmp_path / "c", dirs_exist_ok=True)
        dst = tmp_path / "c" / os.path.relpath(f, src)
        raw = bytearray(open(f, "rb").read())
        if damage == "flip":
            raw[len(raw) // 2] ^= 0x40
        else:
            raw = raw[:values.get(f, len(raw)) - 1]
        dst.write_bytes(bytes(raw))
        with pytest.raises(ocdbt.OcdbtError) as e:
            _orbax.read_tree(str(tmp_path / "c"))
        assert str(dst) in str(e.value), str(e.value)


@pytest.mark.parametrize("layout,dt", CASES)
def test_tree_is_orbax_restore_bitwise(saved, layout, dt):
    path = saved[layout, dt]
    mine = _orbax.read_tree(path)
    ref = ocp.PyTreeCheckpointer().restore(path)
    a = jax.tree_util.tree_leaves_with_path(mine)
    b = jax.tree_util.tree_leaves_with_path(ref)
    assert [p for p, _ in a] == [p for p, _ in b]
    for (p, x), (_, y) in zip(a, b):
        y = np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, p
        assert x.tobytes() == y.tobytes(), p
    assert tcheckpoint.checkpoint_layout(path) == layout


def test_chunked_and_absent_chunks(tmp_path):
    """An array orbax writes in chunks (sharded over the 8 CPU devices) and a
    zarr array with absent chunks, which take its fill value."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    mesh = Mesh(np.array(jax.devices()[:8]).reshape(4, 2), ("a", "b"))
    x = jax.device_put(jnp.arange(8 * 6 * 5, dtype=jnp.float32).reshape(8, 6, 5) / 7.0,
                       NamedSharding(mesh, PartitionSpec("a", "b")))
    ocp.PyTreeCheckpointer().save(str(tmp_path / "sharded"), {"x": x, "y": jnp.arange(3)})
    store = ocdbt.OcdbtStore(str(tmp_path / "sharded"))
    assert len([k for k in store.list() if k.startswith("x/") and "zarray" not in k]) == 8
    tree = _orbax.read_tree(str(tmp_path / "sharded"))
    np.testing.assert_array_equal(tree["x"], np.asarray(x))
    np.testing.assert_array_equal(tree["y"], np.arange(3))

    arr = ts.open({"driver": "zarr", "kvstore": {"driver": "ocdbt",
                                                 "base": f"file://{tmp_path}/zarr/"},
                   "path": "a", "metadata": {"chunks": [3, 4], "fill_value": -2.5, "dtype": "<f8",
                                            "shape": [7, 9],
                                            "compressor": {"id": "zstd", "level": 5}}},
                  create=True).result()
    vals = np.arange(63, dtype=np.float64).reshape(7, 9)
    arr[0:3, 0:4] = vals[0:3, 0:4]
    arr[6:7, 8:9] = vals[6:7, 8:9]
    want = np.asarray(arr.read().result())
    got = _orbax.read_array(ocdbt.OcdbtStore(str(tmp_path / "zarr")), "a")
    np.testing.assert_array_equal(got, want)
    assert (got == -2.5).sum() == 63 - 13


# --- restore_checkpoint -------------------------------------------------------------


def _port_state(dtype, seed=5):
    gen = torch.Generator().manual_seed(seed)
    net = tnetworks.make_ppo_networks(OBS, ACT, preprocess_observations_fn=tnetworks.
                                      normalize_preprocessor, policy_hidden_layer_sizes=HIDDEN,
                                      value_hidden_layer_sizes=HIDDEN, generator=gen,
                                      device="cpu", dtype=dtype)
    return ttrain.TrainingState(params=net,
                                optimizer=tgradients.make_optimizer(net.parameters(), LR),
                                normalizer_params=trs.init_state(torch.zeros(OBS, dtype=dtype)),
                                env_steps=0)


def _assert_equal(t, a, transpose=False):
    a = np.asarray(a)
    a = a.T if transpose else a
    assert tuple(t.shape) == a.shape
    assert t.detach().numpy().tobytes() == np.ascontiguousarray(a).tobytes()


@pytest.mark.parametrize("layout,dt", CASES)
def test_restore_checkpoint_is_orbax_bitwise(saved, layout, dt):
    path = saved[layout, dt]
    dtype = getattr(torch, dt)
    target = _port_state(dtype)
    before = {k: v.clone() for k, v in target.params.state_dict().items()}
    got = tcheckpoint.restore_checkpoint(path, target)
    ref = ocp.PyTreeCheckpointer().restore(path)
    normalizer, params = ((ref["normalizer_params"], ref["params"]) if layout == "full"
                          else (ref[0], ref[1]))
    for f in ("count", "mean", "summed_variance", "std"):
        _assert_equal(getattr(got.normalizer_params, f), normalizer[f])
    net, opt = got.params, got.optimizer
    for name in ("policy", "value"):
        for i, layer in enumerate(getattr(net, name).layers):
            _assert_equal(layer.weight, params[name][i]["kernel"], transpose=True)
            _assert_equal(layer.bias, params[name][i]["bias"])
            if layout != "full":
                continue
            adam = ref["optimizer_state"][0]
            for attr, key in (("weight", "kernel"), ("bias", "bias")):
                s = opt.state[getattr(layer, attr)]
                _assert_equal(s["exp_avg"], adam["mu"][name][i][key], attr == "weight")
                _assert_equal(s["exp_avg_sq"], adam["nu"][name][i][key], attr == "weight")
                assert float(s["step"]) == int(adam["count"]) == 2
    if layout == "full":
        assert got.env_steps == int(ref["env_steps"]) == ENV_STEPS
    else:
        # the reference layout restarts the optimizer and env_steps
        assert got.env_steps == 0 and not opt.state
        assert any(not torch.equal(before[k], v) for k, v in net.state_dict().items())


def test_restore_raises_naming_the_key(saved, tmp_path):
    wide = _port_state(torch.float64)
    wide.params.policy.layers[0] = torch.nn.Linear(OBS + 1, HIDDEN[0], dtype=torch.float64)
    with pytest.raises(ValueError, match="params.policy.0.kernel"):
        tcheckpoint.restore_checkpoint(saved["full", "float64"], wide)
    deep = _port_state(torch.float64)
    deep.params.value.layers.append(torch.nn.Linear(1, 1, dtype=torch.float64))
    with pytest.raises(ValueError, match="params.value: 3 layers"):
        tcheckpoint.restore_checkpoint(saved["full", "float64"], deep)
    # a tree without the params: a KeyError naming them
    jcheckpoint.save_checkpoint(str(tmp_path / "partial"), {"optimizer_state": jnp.ones(1)})
    assert tcheckpoint.checkpoint_layout(str(tmp_path / "partial")) == "full"
    with pytest.raises(KeyError, match="params.policy"):
        tcheckpoint.restore_checkpoint(str(tmp_path / "partial"), _port_state(torch.float64))
    jcheckpoint.save_checkpoint(str(tmp_path / "other"), {"x": jnp.ones(3)})
    assert tcheckpoint.checkpoint_layout(str(tmp_path / "other")) == "unknown"
    with pytest.raises(ValueError, match="neither"):
        tcheckpoint.restore_checkpoint(str(tmp_path / "other"), _port_state(torch.float64))


def _minibatch(rows, T, dtype):
    """A seeded minibatch in the JAX loss's [rows, T, ...] layout."""
    rng = np.random.default_rng(11)
    n = lambda *s: rng.standard_normal(s).astype(dtype)
    return dict(observation=n(rows, T, OBS), action=np.tanh(n(rows, T, ACT)),
                reward=n(rows, T), discount=(rng.random((rows, T)) > 0.2).astype(dtype),
                next_observation=n(rows, 1, OBS), log_prob=n(rows, T) - 2.0,
                raw_action=n(rows, T, ACT), truncation=(rng.random((rows, T)) > 0.9).astype(dtype))


def test_learner_step_after_restore_matches_optax(saved):
    """One learner step from an orbax checkpoint: the port's learn_step on the
    restored state against the JAX update on orbax's restore of it, the same
    minibatch and entropy noise: params and both Adam moments at the PPO
    parity tolerance, the step count bitwise."""
    path = saved["full", "float64"]
    rows, T = 8, 4
    mb = _minibatch(rows, T, np.float64)
    jstate = jcheckpoint.restore_checkpoint(path, _jax_state(jnp.float64, seed=9))
    jnet = jnetworks.make_ppo_networks(OBS, ACT, preprocess_observations_fn=jrs.normalize,
                                       policy_hidden_layer_sizes=HIDDEN,
                                       value_hidden_layer_sizes=HIDDEN)
    update = jax.jit(jgradients.gradient_update_fn(
        functools.partial(jlosses.compute_ppo_loss, ppo_network=jnet, **LOSS_HPARAMS),
        optax.adam(LR), pmap_axis_name=None, has_aux=True))
    jdata = jtypes.Transition(
        observation=mb["observation"], action=mb["action"], reward=mb["reward"],
        discount=mb["discount"], next_observation=mb["next_observation"],
        extras={"policy_extras": {"log_prob": mb["log_prob"], "raw_action": mb["raw_action"]},
                "state_extras": {"truncation": mb["truncation"]}})
    loss_rng = jax.random.PRNGKey(21)
    (_, jmetrics), jparams, jopt = update(jstate.params, jstate.normalizer_params, jdata,
                                          loss_rng, optimizer_state=jstate.optimizer_state)
    eps = torch.as_tensor(np.array(jnp.swapaxes(
        jax.random.normal(loss_rng, (T, rows, ACT), jnp.float64), 0, 1)))

    state = tcheckpoint.restore_checkpoint(path, _port_state(torch.float64))
    t = lambda k: torch.as_tensor(mb[k])
    data = Transition(observation=t("observation"), action=t("action"), reward=t("reward"),
                      discount=t("discount"), next_observation=t("next_observation"),
                      extras={"policy_extras": {"log_prob": t("log_prob"),
                                                "raw_action": t("raw_action")},
                              "state_extras": {"truncation": t("truncation")}})
    state, metrics = ttrain.learn_step(
        state, data, state.normalizer_params, torch.arange(rows)[None], eps[None, None],
        functools.partial(tlosses.compute_ppo_loss, **LOSS_HPARAMS), steps_per_train_step=rows * T)
    assert state.env_steps == ENV_STEPS + rows * T
    np.testing.assert_allclose(metrics["total_loss"].reshape(-1).numpy(),
                               [float(jmetrics["total_loss"])], rtol=RTOL, atol=ATOL)
    adam = jopt[0]
    for name in ("policy", "value"):
        for i, layer in enumerate(getattr(state.params, name).layers):
            for attr, key in (("weight", "kernel"), ("bias", "bias")):
                tr = (lambda a: np.asarray(a).T) if attr == "weight" else np.asarray
                p = getattr(layer, attr)
                s = state.optimizer.state[p]
                np.testing.assert_allclose(p.detach().numpy(), tr(getattr(jparams, name)[i][key]),
                                           rtol=RTOL, atol=ATOL)
                np.testing.assert_allclose(s["exp_avg"].numpy(),
                                           tr(getattr(adam.mu, name)[i][key]), rtol=RTOL,
                                           atol=ATOL)
                np.testing.assert_allclose(s["exp_avg_sq"].numpy(),
                                           tr(getattr(adam.nu, name)[i][key]), rtol=RTOL,
                                           atol=ATOL)
                assert int(s["step"]) == int(adam.count) == 3


def test_train_resumes_from_orbax(tmp_path):
    """The port's train() on the point mass resumes from a JAX orbax
    directory at its env_steps (the evals land at 512 and 512 + 2048) and
    from the reference layout at 0, as the JAX train() does."""
    for layout in ("full", "reference"):
        st = _jax_state(jnp.float64, obs=2, act=2, hidden=(32, 32))
        path = str(tmp_path / layout)
        if layout == "full":
            jcheckpoint.save_checkpoint(path, st)
        else:
            jcheckpoint.save_checkpoint(path, (st.normalizer_params, st.params))
        seen = []
        ttrain.train(PointMass(), num_timesteps=2048, num_evals=2, restore_checkpoint_path=path,
                     network_factory=functools.partial(tnetworks.make_ppo_networks,
                                                       policy_hidden_layer_sizes=(32, 32),
                                                       value_hidden_layer_sizes=(32, 32)),
                     progress_fn=lambda step, m: seen.append(step), **PM_ARGS)
        start = ENV_STEPS if layout == "full" else 0
        assert seen == [start, start + 2048], (layout, seen)


# --- the committed fixtures ---------------------------------------------------------


@pytest.mark.parametrize("name", ["rodent", "rodent_reference"])
def test_committed_fixture_is_a_fresh_orbax_restore(name):
    path = os.path.join(FIXTURES, name)
    arrays = np.load(os.path.join(FIXTURES, "rodent.npz"))
    ref = ocp.PyTreeCheckpointer().restore(path)
    mine = _orbax.read_tree(path)
    prefix = {"0": "normalizer_params", "1": "params"}
    for (p, x), (_, y) in zip(jax.tree_util.tree_leaves_with_path(mine),
                              jax.tree_util.tree_leaves_with_path(ref)):
        keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in p]
        if name.endswith("reference"):
            keys[0] = prefix[keys[0]]
        key = ".".join(keys)
        assert x.tobytes() == np.asarray(y).tobytes() == arrays[key].tobytes(), key
    assert tcheckpoint.checkpoint_layout(path) == (
        "reference" if name.endswith("reference") else "full")
