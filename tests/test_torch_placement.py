"""PyTorch port: one card per rank — the placement rule
(``parallel/mesh.py::rank_device``) and where it is applied: the spawned
ranks of ``entry.spawn_worlds`` / ``dryrun_multichip`` and
``multihost.initialize``.

There is no card here: ``torch.cuda.is_available``, ``device_count`` and
``set_device`` and ``torch.distributed.init_process_group`` are replaced by
fakes that record their calls, so the tests see which card each process
takes and that it takes it before its process group starts. JAX's
counterparts take n distinct devices for n (its dryrun raises "need N
devices, have M" first); under NCCL the port must do the same.
"""

import types

import pytest
import torch
import torch.distributed as dist

from fmcw_radar_processing_tpu_torch import entry
from fmcw_radar_processing_tpu_torch.parallel import multihost
from fmcw_radar_processing_tpu_torch.parallel.mesh import rank_device


@pytest.fixture
def cards(monkeypatch):
    """A host with ``cards.n`` CUDA cards (4 unless a test sets it); the
    calls of set_device, init_process_group and mp.spawn in order."""

    host = types.SimpleNamespace(n=4, calls=[])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: host.n)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: host.calls.append(("set_device", torch.device(d))))
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **k: host.calls.append(("init", k)))
    monkeypatch.setattr(dist, "destroy_process_group", lambda: None)
    monkeypatch.setattr(torch.multiprocessing, "spawn",
                        lambda *a, **k: host.calls.append(("spawn", k)))
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    return host


@pytest.mark.parametrize("rank", range(4))
def test_nccl_rank_r_takes_card_r(cards, rank):
    assert rank_device("cuda", rank, "nccl", 4) == torch.device("cuda", rank)


def test_nccl_one_rank_keeps_its_named_card(cards):
    assert rank_device("cuda:0", 0, "nccl", 1) == torch.device("cuda", 0)
    assert rank_device("cuda:3", 0, "nccl", 1) == torch.device("cuda", 3)
    assert rank_device("cuda", 0, "nccl", 1) == torch.device("cuda", 0)


@pytest.mark.parametrize("index", [0, 2])
def test_nccl_explicit_index_above_one_rank_raises(cards, index):
    with pytest.raises(ValueError, match="cannot hold 2 NCCL ranks"):
        rank_device(f"cuda:{index}", 0, "nccl", 2)
    with pytest.raises(ValueError, match="cannot hold 4 NCCL ranks"):
        entry.spawn_worlds((2, 4), print, None, "nccl", f"cuda:{index}")
    assert cards.calls == []


@pytest.mark.parametrize("local_world", [2, 4])
def test_nccl_more_ranks_than_cards_raises_before_any_group(cards, local_world):
    cards.n = local_world - 1
    want = f"need {local_world} devices, have {local_world - 1}"
    with pytest.raises(RuntimeError, match=want):
        rank_device("cuda", 0, "nccl", local_world)
    with pytest.raises(RuntimeError, match=want):
        entry.spawn_worlds((1, local_world), print, None, "nccl", "cuda")
    with pytest.raises(RuntimeError, match=want):  # before the kernel build too
        entry.dryrun_multichip(local_world, "nccl", "cuda", recording=([], []))
    assert cards.calls == []  # no card set, no group, no spawn


@pytest.mark.parametrize("device", ["cuda", "cuda:0"])
def test_gloo_on_one_card_puts_every_rank_on_card_0(cards, device):
    cards.n = 1
    for rank in range(4):
        assert rank_device(device, rank, "gloo", 4) == torch.device("cuda", 0)


def test_gloo_spreads_unindexed_ranks_over_the_cards(cards):
    cards.n = 2
    assert [rank_device("cuda", r, "gloo", 4).index for r in range(4)] == [0, 1, 0, 1]
    assert {rank_device("cuda:1", r, "gloo", 4).index for r in range(4)} == {1}


@pytest.mark.parametrize("backend", ["nccl", "gloo"])
def test_cpu_stays_the_cpu(cards, backend):
    assert rank_device("cpu", 3, backend, 4) == torch.device("cpu")


@pytest.mark.parametrize("backend,device,card", [("nccl", "cuda", 2),
                                                 ("gloo", "cuda", 2),
                                                 ("gloo", "cuda:1", 1),
                                                 ("gloo", "cpu", None)])
def test_rank_body_sets_its_card_before_its_group(cards, tmp_path, backend,
                                                  device, card):
    """Rank 2 of a spawned world of 4: its card current first; the group,
    under NCCL, bound to it (device_id); fn gets the rank's device."""
    got = []
    entry._rank_body(2, (4,), backend, device, str(tmp_path),
                     lambda dev, payload: got.append((dev, payload)), None,
                     payload="p")
    want = torch.device(device if card is None else f"cuda:{card}")
    assert got == [(want, "p")]
    calls = [c[0] for c in cards.calls]
    assert calls == (["init"] if card is None else ["set_device", "init"])
    if card is not None:
        assert cards.calls[0][1] == want
    init = cards.calls[-1][1]
    assert (init["rank"], init["world_size"]) == (2, 4)
    assert init.get("device_id") == (want if backend == "nccl" else None)


def _init(cards, pid, nproc=4):
    assert multihost.initialize("file:///nowhere", nproc, pid, "nccl") == 0
    (_, card), (_, init) = cards.calls
    assert init["device_id"] == card and init["rank"] == pid
    return card


@pytest.mark.parametrize("pid", range(4))
def test_initialize_binds_process_id_mod_cards(cards, pid):
    assert _init(cards, pid) == torch.device("cuda", pid)


def test_initialize_wraps_process_ids_past_this_hosts_cards(cards):
    """Eight processes, four a host: process 6 is the second host's
    cuda:2."""
    assert _init(cards, 6, nproc=8) == torch.device("cuda", 2)


def test_initialize_prefers_local_rank(cards, monkeypatch):
    monkeypatch.setenv("LOCAL_RANK", "3")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    assert _init(cards, 1) == torch.device("cuda", 3)


def test_initialize_raises_before_its_group_with_too_few_cards(cards, monkeypatch):
    cards.n = 2
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    with pytest.raises(RuntimeError, match="need 4 devices, have 2"):
        multihost.initialize("file:///nowhere", 4, 1, "nccl")
    monkeypatch.setenv("LOCAL_RANK", "2")
    monkeypatch.delenv("LOCAL_WORLD_SIZE")
    with pytest.raises(RuntimeError, match="need 3 devices, have 2"):
        multihost.initialize("file:///nowhere", 4, 2, "nccl")
    assert cards.calls == []


def test_initialize_under_gloo_binds_no_card(cards):
    assert multihost.initialize("file:///nowhere", 2, 1, "gloo") == 0
    assert [c[0] for c in cards.calls] == ["init"]
    assert "device_id" not in cards.calls[0][1]
