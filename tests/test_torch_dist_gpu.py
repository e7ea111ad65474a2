"""fp8 gradient compression and the recorded collectives on the card.
Marked ``gpu``; each test skips without a CUDA device.

Bars: bitwise.  The compression is RTN QDQ, IEEE division and exact
fp8 sums, so a CUDA tensor's result equals the CPU's bit for bit; over
a world of one NCCL rank ``compressed_psum`` equals
``fp8_compress_grads`` (the shared scale is the tensor's own) and its
gradient payload is 1-byte codes.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.nn.params import map_specs
from repro_torch.optim import (compressed_psum_grads, compressed_reduce_dp,
                               fp8_compress_grads)
from repro_torch.tree import tree_leaves, tree_map

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card, see README)")
    return torch.device("cuda")


def _grads(seed, lead=()):
    """A gradient-like tree of every leaf shape of gpt2-125m (scales
    spread over leaves) and small residuals, on the CPU."""
    specs = build_model(get_config("gpt2-125m"), "meta").param_specs()
    gen = torch.Generator().manual_seed(seed)
    scales = iter(10.0 ** torch.empty(4096).uniform_(-6, 2, generator=gen))
    g = map_specs(lambda s: torch.randn(lead + s.shape, generator=gen)
                  * next(scales), specs)
    r = tree_map(lambda t: torch.randn(t.shape, generator=gen) * 1e-6, g)
    return g, r


def _equal(a_tree, b_tree):
    for a, b in zip(tree_leaves(a_tree), tree_leaves(b_tree)):
        np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())


def test_compression_on_card_equals_cpu(card):
    g, r = _grads(0)
    want = fp8_compress_grads(g, r)
    got = fp8_compress_grads(tree_map(lambda t: t.to(card), g),
                             tree_map(lambda t: t.to(card), r))
    _equal(got[0], want[0])
    _equal(got[1], want[1])
    gd, rd = _grads(1, lead=(2,))
    gd = {"embed": gd["embed"], "pos_embed": gd["pos_embed"],
          "final_norm": gd["final_norm"]}
    rd = {k: rd[k] for k in gd}
    want = compressed_reduce_dp(gd, rd)
    got = compressed_reduce_dp(tree_map(lambda t: t.to(card), gd),
                               tree_map(lambda t: t.to(card), rd))
    _equal(got[0], want[0])
    _equal(got[1], want[1])


def test_nccl_world_of_one(card, tmp_path):
    import torch.distributed as dist
    from repro_torch.distributed import comms
    dist.init_process_group(
        "nccl", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1)
    try:
        g, r = _grads(2)
        g = tree_map(lambda t: t.to(card), g)
        r = tree_map(lambda t: t.to(card), r)
        with comms.recording() as log:
            red, res = compressed_psum_grads(g, r)
        want, want_res = fp8_compress_grads(g, r)
        _equal(red, want)
        _equal(res, want_res)
        codes = [c for c in log if c.tag == "grad_codes"]
        assert len(codes) == len(tree_leaves(g))
        assert all(c.dtype == "uint8" and c.nbytes == int(np.prod(c.shape))
                   and c.op == "all-gather" for c in codes)
        assert sum(c.nbytes for c in codes) == sum(
            t.numel() for t in tree_leaves(g))
    finally:
        dist.destroy_process_group()
