"""fp8 gradient compression, the recorded collectives, and an MoE layer
and a mamba mixer split over the model axis on the card.  Marked ``gpu``; each test skips
without a CUDA device.

Bars: bitwise.  The compression is RTN QDQ, IEEE division and exact
fp8 sums, so a CUDA tensor's result equals the CPU's bit for bit; over
a world of one NCCL rank ``compressed_psum`` equals
``fp8_compress_grads`` (the shared scale is the tensor's own) and its
gradient payload is 1-byte codes.  The batched amax-in entry's quantized
panels (a rank's half of every 128-wide group, maxed over two gloo
ranks) equal its plain version's bit for bit.  The d_ff-split MoE
sublayer through the kernels against the same ranks through the plain
versions: relative L2 ``EXPERT_TP_RTOL`` (the products' f32
accumulation order, and the FP4 / FP8 elements it flips downstream),
which the kernels with each rank's own amax must exceed on the output.
mamba2-780m's mixer with its heads split over two ranks through the
kernels against the plain versions at ``MAMBA_TP_RTOL``, which the
control (each rank's own norm statistic) must exceed on the output.
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


# set from the card (NVIDIA H100 80GB HBM3, 700 W): the kernels read at
# most 1.3e-4 from the plain versions on any output, the own-amax
# control 3.2e-2 (fp8) and 1.5e-1 (paper_fp4) on the sublayer's output
EXPERT_TP_RTOL = 1e-3


def _rel(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def test_expert_tensor_parallel_on_card(card, tmp_path):
    """olmoe-1b-7b ``REDUCED`` with 3 experts on two gloo ranks on the
    card, d_ff split inside every expert: under paper_fp4 the batched
    amax-in entry of ``qmm_stream`` (block / tile groups a rank holds 32
    of 128 of) and under fp8 the batched shared amax of ``quantize_rows``
    (token groups along the row-parallel K) launch, and the sublayer's
    output, input cotangent and gradients match the plain versions'; the
    control (the kernels with each rank's own amax) misses the output;
    the entry's panels are bitwise the plain version's."""
    from torch_dist_workers import run_ranks
    recipes = ("paper_fp4", "fp8")
    ranks = run_ranks("expert_tp_card", 2, tmp_path, recipes)
    for rank, r in enumerate(ranks):
        assert r["panels"] == 0
        for recipe in recipes:
            case = r[recipe]
            errs = [_rel(g, w) for g, w in zip(case["kernels"],
                                               case["plain"])]
            own = [_rel(g, w) for g, w in zip(case["own"], case["plain"])]
            print(f"rank {rank} {recipe}: kernels {errs} own amax {own}")
            assert max(errs) <= EXPERT_TP_RTOL, (recipe, errs)
            assert own[0] > EXPERT_TP_RTOL, (recipe, own)
            counts = case["launches"]
            name = "qmm_stream" if recipe == "paper_fp4" else \
                "quantize_rows"
            assert counts[name]["batched"] > 0, (recipe, counts)


# the mamba mixer through the kernels against the plain versions (bf16:
# the products' f32 accumulation order and the FP4 / FP8 elements it
# flips), predicted before the card's first reading
MAMBA_TP_RTOL = 1e-2


def test_mamba_tensor_parallel_on_card(card, tmp_path):
    """mamba2-780m's mixer at full width on two gloo ranks on the card,
    24 of 48 heads a rank, paper_fp4: through the kernels (in_dt's 24
    columns sharing their tile's amax, out_proj row-parallel, the norm's
    statistic summed both ways) the norm input, output, input cotangent
    and gradients match the plain versions'; the control (each rank's
    own statistic) misses the output; ``qmm_stream`` launched."""
    from torch_dist_workers import run_ranks
    ranks = run_ranks("mamba_tp_card", 2, tmp_path)
    for rank, r in enumerate(ranks):
        errs = [_rel(g, w) for g, w in zip(r["kernels"], r["plain"])]
        own = [_rel(g, w) for g, w in zip(r["own"], r["plain"])]
        print(f"rank {rank} mamba: kernels {errs} own statistic {own}")
        assert max(errs) <= MAMBA_TP_RTOL, errs
        assert own[1] > MAMBA_TP_RTOL, own
        assert r["launches"]["qmm_stream"]["launches"] > 0
