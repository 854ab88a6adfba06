"""PyTorch port: the Trainer's and the streaming processor's ``mesh``.

Spawned gloo ranks on the CPU (tests/_torch_parallel_ranks.py) at world
sizes 1, 2 and 4 run one data-parallel Trainer step and two windows of the
channel-sharded StreamingProcessor; their gathered results are held to
the JAX package — the dropout-off step of tests/test_torch_train.py on the
global batch (JAX's data-parallel step is its single-device step by
construction), and ``StreamingProcessor(mesh=...)`` on the suite's
virtual devices with tests/test_torch_streaming.py's port-to-JAX window
bounds (the PSD within 1e-4 of each channel's window max) — and to the
port's one-process Trainer (dropout and augmentation on) and processor:
there bit for bit, stricter than ``test_streaming.py::
test_multichannel_mesh``'s rtol 1e-2 between JAX's mesh and solo runs.
"""

import types

import jax
import numpy as np
import optax
import pytest
import torch

from fmcw_radar_processing_tpu.models import train as jtrain
from fmcw_radar_processing_tpu.parallel.mesh import make_mesh as jmake_mesh
from fmcw_radar_processing_tpu.pipeline.streaming import (
    StreamingProcessor as JaxStreamingProcessor,
)
from fmcw_radar_processing_tpu_torch import config as tconfig
from fmcw_radar_processing_tpu_torch.models.params import flatten_tree, state_dict_to_flax
from fmcw_radar_processing_tpu_torch.models.train import TrainConfig, Trainer
from fmcw_radar_processing_tpu_torch.pipeline.streaming import StreamingProcessor

from ._torch_parallel_ranks import spawn_worlds
from .test_torch_streaming import _assert_window_equal, _channel
from .test_torch_train import (
    CLEAR_SHARE,
    SHAPE,
    _batch,
    _flax,
    _jax_value_and_grad,
    _leaves,
)

WORLDS = (1, 2, 4)
LR = 1e-3
CHANNELS, WINDOW = 4, 4
MODES = ("per_window", "running_max")


def _inputs():
    cfg = tconfig.RadarConfig.create(tconfig.default_device_config())
    rng = np.random.default_rng(7)
    chans = [_channel(cfg, rng, 2 * WINDOW, bins, muted, gain) for bins, muted, gain in (
        ((40, 90), (1, 5), 1.0), ((60,), (0, 6, 7), 0.5 - 0.2j),
        ((30,), (2,), 0.8), ((70, 100), (3, 4), 1.2 + 0.1j))]
    _, params = _flax("small")
    x, y = _batch(np.random.default_rng(0))
    out = {"stream_raw": np.stack([c[0] for c in chans]),
           "stream_calib": np.stack([c[1] for c in chans]),
           "stream_window": np.array(WINDOW), "train_x": x, "train_y": y,
           "train_lr": np.array(LR)}
    out.update({"p/" + k: v for k, v in _leaves(params).items()})
    return out


INPUTS = _inputs()
_RUNS: dict = {}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread in this process too, as in the ranks."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ranks(world: int) -> list[dict]:
    if not _RUNS:  # one spawn for worlds 1, 2 and 4
        _RUNS.update(spawn_worlds(WORLDS, INPUTS, ("train", "stream")))
    return _RUNS[world]


def _params(res: dict, prefix: str) -> dict:
    return {k[len(prefix) + 2:]: v for k, v in res.items()
            if k.startswith(prefix + "p/")}


def _one_process(augment: bool):
    """The port's one-process Trainer from the same parameters: (params
    after one step on the global batch, its gradients, its loss)."""
    _, params = _flax("small")
    x, y = INPUTS["train_x"], INPUTS["train_y"]
    t = Trainer("small", TrainConfig(learning_rate=LR, epochs=1, batch_size=len(x),
                                     augment=augment), SHAPE, "cpu",
                dtype=torch.float32)
    t.set_params(params)
    if not augment:
        t.model.dropout = 0.0
    t.fit(x, y)
    grads = flatten_tree(state_dict_to_flax(
        {k: p.grad for k, p in t.model.named_parameters()}))
    return (flatten_tree(state_dict_to_flax(t.model.state_dict())), grads,
            t.history[0]["loss"])


def _assert_one_step(got: dict, want: dict, grads: dict):
    """test_torch_train.py's bound for one Adam step: every element within
    2·lr, within 1e-2·lr where |g| > 1e-4·max|g| of its leaf."""
    assert got.keys() == want.keys()
    for k, w in want.items():
        d = np.abs(got[k] - w)
        clear = np.abs(grads[k]) > CLEAR_SHARE * np.abs(grads[k]).max()
        assert d.max() <= 2 * LR, k
        assert d[clear].max(initial=0.0) <= 1e-2 * LR, (k, d.max())


@pytest.mark.parametrize("world", WORLDS)
def test_dp_train_step_matches_jax(world):
    """One step of Trainer(mesh=...) on the global batch of 8 (each rank
    its rows), dropout and augmentation off, vs JAX's loss, gradients and
    optax's Adam on the same batch (the batch order of the seed)."""
    _, params = _flax("small")
    x, y = INPUTS["train_x"], INPUTS["train_y"]
    order = np.random.default_rng(42).permutation(len(x))
    (loss, _), grads = _jax_value_and_grad("small")(params, x[order], y[order])
    tx = jtrain.make_optimizer(jtrain.TrainConfig(learning_rate=LR), params)
    updates, _ = tx.update(grads, tx.init(params), params)
    want = _leaves(optax.apply_updates(params, updates))
    for res in ranks(world):
        assert abs(float(res["train_loss"]) - float(loss)) <= 1e-5 * float(loss)
        _assert_one_step(_params(res, "train_"), want, _leaves(grads))


@pytest.mark.parametrize("world", WORLDS)
def test_dp_train_step_is_the_one_process_step(world):
    """Dropout and augmentation ON: the ranks draw the global batch's masks
    and affine maps from the shared generators and keep their rows, so the
    DP step is the one-process step (bit-equal at world 1; within the
    one-step bound of a reassociated gradient sum above)."""
    want, grads, loss = _one_process(augment=True)
    for res in ranks(world):
        got = _params(res, "train_drop_")
        assert float(res["train_drop_loss"]) == pytest.approx(loss, rel=1e-5)
        if world == 1:
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])
        _assert_one_step(got, want, grads)
    off, _, _ = _one_process(augment=False)
    moved = max(np.abs(_params(ranks(world)[0], "train_drop_")[k] - off[k]).max()
                for k in off)
    assert moved > 1e-2 * LR  # dropout and augmentation did change the step


@pytest.mark.parametrize("world", [2, 4])
def test_dp_train_rejects_an_indivisible_batch(world):
    assert all(int(r["train_raises"]) == 1 for r in ranks(world))


def _window(res: dict, mode: str, i: int):
    pre = f"stream_{mode}_{i}_"
    return types.SimpleNamespace(**{k[len(pre):]: v for k, v in res.items()
                                    if k.startswith(pre)})


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("world", WORLDS)
def test_stream_mesh_matches_jax(world, mode, cfg):
    """StreamingProcessor(mesh=...) at ``world`` ranks vs JAX's with a
    ``world``-device mesh, window by window (the state carried over)."""
    ref = JaxStreamingProcessor(cfg, channels=CHANNELS, window_frames=WINDOW,
                                mesh=jmake_mesh(data=world, model=1,
                                                devices=jax.devices()[:world]),
                                db_mode=mode)
    raw, cal = INPUTS["stream_raw"], INPUTS["stream_calib"]
    got = ranks(world)[-1]
    for i in range(2):
        want = ref.process_window(raw[:, i * WINDOW:(i + 1) * WINDOW], cal)
        _assert_window_equal(_window(got, mode, i), want)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("world", WORLDS)
def test_stream_mesh_is_the_unsharded_processor(world, mode, cfg):
    """Channels are independent: the gathered windows are the port's
    one-process processor's on every channel; every rank gathers the
    same."""
    one = StreamingProcessor(cfg, CHANNELS, WINDOW, "cpu", db_mode=mode)
    raw, cal = INPUTS["stream_raw"], INPUTS["stream_calib"]
    res = ranks(world)
    for i in range(2):
        want = one.process_window(raw[:, i * WINDOW:(i + 1) * WINDOW], cal)
        for r in res:
            got = _window(r, mode, i)
            for k in ("waterfall", "detected", "col_count", "psd", "psd_db",
                      "norm_power", "carry"):
                np.testing.assert_array_equal(getattr(got, k),
                                              getattr(want, k).numpy(), err_msg=k)
            np.testing.assert_array_equal(got.range, want.range.numpy())


def test_stream_rejects_indivisible_channels(cfg):
    """5 channels over a 2- or 4-rank data axis raise ValueError."""
    assert int(ranks(2)[0]["stream_raises"]) == 1
    assert int(ranks(4)[0]["stream_raises"]) == 1
    fake = types.SimpleNamespace(shape={"data": 3}, index=lambda axis: 0)
    with pytest.raises(ValueError, match="not divisible by the data axis"):
        StreamingProcessor(cfg, 4, 4, "cpu", mesh=fake)
