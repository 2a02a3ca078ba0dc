"""PyTorch port: ``SimpleRand.rand_x_tensor``, the reference's
``simple_rand_x`` stream drawn on a torch device by jump-ahead, equals
the host's ``rand_x_batch`` bit for bit (the draws, and the state after
them), draws whose uint64 value lies on a float64 rounding halfway
included; the card's draws equal the host's too (a card-only case)."""

import numpy as np
import pytest
import torch

from graphblas_tpu_torch.utils.simple_rand import SimpleRand

SEEDS = [1, 42, 2**31 - 1, 2**31 + 41, 2**63 + 5, 2**64 - 1]
LENGTHS = [0, 1, 2, 7, 1000, 4099]


def same_bits(got: torch.Tensor, want: np.ndarray) -> None:
    assert got.dtype == torch.float64
    got = got.cpu().numpy()
    assert got.shape == want.shape
    assert np.array_equal(got.view(np.uint64), want.view(np.uint64))


def chains(seed: int, n: int) -> np.ndarray:
    """The uint64 value of each of n draws (simple_rand_i), before the
    division."""
    d = SimpleRand(seed).rand_batch(5 * n).reshape(n, 5).astype(np.uint64)
    i = np.zeros(n, np.uint64)
    for k in range(5):
        i = i * np.uint64(32767) + d[:, k]
    return i


def halfway(i: np.ndarray) -> np.ndarray:
    """Whether each uint64 lies exactly halfway between two float64s:
    the bits below its 53-bit significand are 100...0."""
    top = np.floor(np.log2(np.maximum(i, 1).astype(np.float64))).astype(
        np.int64)
    # log2's float rounding may put a value just under 2^k at k
    top = np.where(i < (np.uint64(1) << top.astype(np.uint64)), top - 1,
                   top)
    drop = np.maximum(top - 52, 0).astype(np.uint64)
    low = i & ((np.uint64(1) << drop) - np.uint64(1))
    return (drop > 0) & (low == (np.uint64(1) << drop) >> np.uint64(1))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", LENGTHS)
def test_device_stream_equals_host_stream(seed, n):
    host, dev = SimpleRand(seed), SimpleRand(seed)
    for _ in range(2):      # a second draw continues both streams
        same_bits(dev.rand_x_tensor(n, "cpu"), host.rand_x_batch(n))
        assert dev.state == host.state and dev.state.dtype == np.uint64


def test_lengths_interleaved_with_scalar_draws():
    """Draws of changing lengths, with the scalar draws between them,
    keep both streams in step (the jump-ahead maps are kept for each
    length)."""
    host, dev = SimpleRand(7), SimpleRand(7)
    for n in (3, 3, 10, 1, 10):
        same_bits(dev.rand_x_tensor(n, "cpu"), host.rand_x_batch(n))
        assert dev.rand_x() == host.rand_x()
        assert dev.rand() == host.rand()
    assert dev.state == host.state


def test_halfway_draws_round_to_even():
    """Draws whose uint64 value lies halfway between two float64s (about
    one in 350 here) round to nearest even, as numpy's cast and Python's
    int-to-float conversion do; about half of them would round the other
    way if cut toward zero."""
    seed, n = 2**31 + 41, 20000
    i = chains(seed, n)
    at = np.nonzero(halfway(i))[0]
    assert at.size >= 20
    got = SimpleRand(seed).rand_x_tensor(n, "cpu").numpy()[at]
    want = np.array([float(int(u)) for u in i[at]]) / float(2**64 - 1)
    assert np.array_equal(got.view(np.uint64), want.view(np.uint64))
    same_bits(torch.from_numpy(got), SimpleRand(seed).rand_x_batch(n)[at])
    cut = np.array([float(int(u) >> (int(u).bit_length() - 53) << (
        int(u).bit_length() - 53)) for u in i[at]]) / float(2**64 - 1)
    assert 0 < np.count_nonzero(cut != want) < at.size


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
def test_card_stream_equals_host_stream(seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    host, dev = SimpleRand(seed), SimpleRand(seed)
    for n in (1, 1000, 262144):
        got = dev.rand_x_tensor(n, "cuda")
        assert got.device.type == "cuda"
        same_bits(got, host.rand_x_batch(n))
        assert dev.state == host.state
