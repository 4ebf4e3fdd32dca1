"""nvidia-smi is read for the card torch runs on, matched by its UUID:
nvidia-smi lists every card of the host and ignores CUDA_VISIBLE_DEVICES."""
from __future__ import annotations

import os
import subprocess
import time
import types

import pytest
import torch

from port_bench import devtrace

# torch sees the host's cards 3 and 5 as its devices 0 and 1
UUIDS = {0: "8a1f0c3e-0000-4000-8000-000000000003", 1: "GPU-8A1F0C3E-0000-4000-8000-000000000005"}
HOST = ("GPU-8a1f0c3e-0000-4000-8000-000000000001, 11\n"
        "GPU-8a1f0c3e-0000-4000-8000-000000000003, 33\n"
        "GPU-8a1f0c3e-0000-4000-8000-000000000005, 55\n")


@pytest.fixture
def visible(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: types.SimpleNamespace(uuid=UUIDS[device]))


def _smi(monkeypatch, stdout):
    calls = []

    def run(cmd, **kw):
        calls.append(cmd)
        return types.SimpleNamespace(stdout=stdout)

    monkeypatch.setattr(subprocess, "run", run)
    return calls


def test_the_card_is_named_by_the_uuid_of_torchs_device(visible):
    assert devtrace.card_uuid() == "GPU-" + UUIDS[0]
    assert devtrace.card_uuid(1) == "GPU-" + UUIDS[1][4:].lower()


def test_memory_is_read_of_torchs_card_not_the_hosts_first(visible, monkeypatch):
    calls = _smi(monkeypatch, HOST)
    assert devtrace.card_memory_used_bytes() == 33 * 2 ** 20
    assert "-i" not in calls[0]


def test_a_host_with_one_card_is_read_whatever_its_uuid_reads(visible, monkeypatch):
    _smi(monkeypatch, "GPU-ffffffff-0000-4000-8000-000000000009, 77\n")
    assert devtrace.card_memory_used_bytes() == 77 * 2 ** 20
    _smi(monkeypatch, HOST.replace("000000000003", "000000000002"))
    assert devtrace.card_memory_used_bytes() is None


def test_no_card_no_reading(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert devtrace.card_uuid() is None and devtrace.card_memory_used_bytes() is None
    smi = devtrace.Smi()
    smi.stop()
    assert smi.samples == []


def test_the_sampler_keeps_only_torchs_card(visible, monkeypatch, tmp_path):
    """A fake nvidia-smi prints the host's three cards (uuid, util %, MiB) every 50 ms."""
    lines = "".join(f"{u}, {n}, {n * 100}\\n" for u, n in
                    [(h.split(",")[0], int(h.split(",")[1])) for h in HOST.splitlines()])
    fake = tmp_path / "nvidia-smi"
    fake.write_text(f"#!/bin/sh\nwhile true; do printf '{lines}'; sleep 0.05; done\n")
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", f"{tmp_path}:{os.environ['PATH']}")
    smi = devtrace.Smi()
    time.sleep(0.5)
    smi.stop()
    assert smi.samples and {(u, m) for _, u, m in smi.samples} == {(33.0, 3300.0)}
