"""The compulsory bytes of each entry, by hand, and the roofline share
they give."""

import pytest
import torch

from gbbench.metrics import call_roofline
from gbbench.roofline import bfs_csr, mxm, tricount_auto


def test_tricount_bytes():
    # L and U: (n + 1) int32 row pointers and m int32 indices each; 8 out
    assert tricount_auto.compulsory_bytes({"n": 3, "m": 2}) == 2 * (16 + 8) + 8
    # gap-kron-20: 15,700,163 edges, about 134 MB
    b = tricount_auto.compulsory_bytes({"n": 1 << 20, "m": 15_700_163})
    assert b == 2 * (4 * ((1 << 20) + 1) + 4 * 15_700_163) + 8
    assert 133e6 < b < 135e6


def test_mxm_bytes():
    info = {"n": 4, "nnz": {"L": 3, "U": 3, "M": 3}, "nnz_C": 2}
    # M, L, U and C: 5 row pointers each, 8 bytes an entry
    assert mxm.compulsory_bytes(info) == 4 * 20 + 8 * (9 + 2)


def test_bfs_bytes():
    assert bfs_csr.compulsory_bytes({"n": 5, "nnz": 8}) == 24 + 32 + 20


def test_roofline_share(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA H100 80GB HBM3")
    ctx = {"device": torch.device("cuda:0"), "bytes_per_call": 3.35e9,
           "trace": {"check": {"ok": True}, "busy_s": 4.0, "calls": 2,
                     "window_s": 5.0}}
    # 1 ms at 3.35 TB/s over 2 s busy a call
    assert call_roofline.read(ctx) == pytest.approx(0.05)
    ctx["trace"]["check"]["ok"] = False
    assert call_roofline.read(ctx) is None
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "a card the table lacks")
    ctx["trace"]["check"]["ok"] = True
    assert call_roofline.read(ctx) is None
    ctx["device"] = torch.device("cpu")
    assert call_roofline.read(ctx) is None
