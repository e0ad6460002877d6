"""The run's host side on the CPU: the card's local CPUs read from a
sysfs-style tree, the fallback where there is none, the binding, the
frozen set-up heap, and the line each run logs about it."""
from __future__ import annotations

import gc
import json
import os
import re
import types

import pytest
import torch

from pb import cells, common

PCI = "0000:19:00.0"


def test_a_cpulist_is_parsed_and_written_back():
    cpus = common.parse_cpulist("0-15,32-47\n")
    assert cpus == list(range(16)) + list(range(32, 48))
    assert common.format_cpulist(cpus) == "0-15,32-47"
    assert common.parse_cpulist("3") == [3]
    assert common.format_cpulist([5, 0, 1, 2]) == "0-2,5"


def _sysfs(tmp_path, cpulist=None, node=None):
    dev = tmp_path / PCI
    dev.mkdir()
    if cpulist is not None:
        (dev / "local_cpulist").write_text(cpulist + "\n")
    if node is not None:
        (dev / "numa_node").write_text(f"{node}\n")
    return tmp_path


def test_the_cards_local_cpus_are_read_from_sysfs(tmp_path):
    have = sorted(os.sched_getaffinity(0))
    # a list naming the allowed CPUs and one that does not exist here
    text = common.format_cpulist(have + [max(have) + 1000])
    host = common.card_local_cpus(PCI, _sysfs(tmp_path, text, 1))
    assert host.how == "card-local" and host.node == 1
    assert host.cpus == have


@pytest.mark.parametrize("case", ["no file", "no address", "none allowed"])
def test_the_run_falls_back_to_the_cpus_it_has(tmp_path, case):
    have = sorted(os.sched_getaffinity(0))
    if case == "no file":
        host = common.card_local_cpus(PCI, _sysfs(tmp_path, None, -1))
    elif case == "no address":
        host = common.card_local_cpus(None, tmp_path)
    else:
        far = common.format_cpulist([max(have) + 1000])
        host = common.card_local_cpus(PCI, _sysfs(tmp_path, far, 0))
    assert host.cpus == have
    assert host.how.startswith("fallback")
    assert host.node in (None, 0)


def test_the_pci_address_comes_from_the_cards_properties():
    props = types.SimpleNamespace(pci_domain_id=0, pci_bus_id=0x19,
                                  pci_device_id=0)
    fake = types.SimpleNamespace(cuda=types.SimpleNamespace(
        get_device_properties=lambda i: props))
    assert common.card_pci_address(fake) == PCI
    props = types.SimpleNamespace()
    assert common.card_pci_address(fake) is None


def test_pinning_binds_the_main_thread(monkeypatch):
    before = os.sched_getaffinity(0)
    one = min(before)
    monkeypatch.setattr(common, "card_pci_address", lambda t, i=0: PCI)
    monkeypatch.setattr(common, "card_local_cpus",
                        lambda pci: common.HostSide([one], 0, "card-local"))
    try:
        host = common.pin_host(torch)
        assert os.sched_getaffinity(0) == {one}
        assert host.cpus == [one]
    finally:
        os.sched_setaffinity(0, before)


def test_set_up_ends_with_its_heap_frozen():
    try:
        assert common.end_setup(0.0) > 0
        assert gc.get_freeze_count() > 0
        assert gc.isenabled()
    finally:
        gc.unfreeze()
    assert common.step_p50_ms([0.0, 0.001, 0.003, 0.006]) == \
        pytest.approx(2.0)
    assert common.step_p50_ms([0.0]) is None


def test_run_logs_its_host_side_before_the_checks(monkeypatch, capsys):
    """`run.main` through a fake card and runner: the host line names the
    CPUs, the node, the main thread's last CPU and the window's p50 step,
    and the checks stay the last lines of standard error."""
    import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "fake")
    monkeypatch.setattr(common, "power_limit", lambda: "fake, 700.00 W")
    monkeypatch.setattr(common, "card_pci_address", lambda t, i=0: None)
    checks = {"loss_gap": {"value": 1e-9, "limit": 1e-5}}
    out = {"correct": True, "checks": checks, "attempted": 9, "failed": 0,
           "memory_peak_bytes": 1, "step_p50_ms": 2.5,
           "e2e": {"setup_s": 1.0, "sparse_samples_per_s": 2.0,
                   "peak_mem_gib": 1.0}}
    monkeypatch.setattr(cells, "run", lambda ctx: out)
    before = os.sched_getaffinity(0)
    try:
        run.main(["--workload", "dpmr-lr-13x2e27.sgd-b65536", "--seed", "1",
                  "--seconds", "1"])
    finally:
        os.sched_setaffinity(0, before)
    got = capsys.readouterr()
    err = got.err.strip().splitlines()
    have = common.format_cpulist(before)
    assert re.fullmatch(
        rf"\[host\] cpus {re.escape(have)} node unknown \(fallback: no PCI "
        r"address for the card\); main thread last on cpu \d+; window p50 "
        r"step 2\.500 ms", err[-2]), err
    assert err[-1].startswith("check loss_gap")
    assert json.loads(got.out.strip().splitlines()[-1])["correct"]
