"""Roofline and MFU counts against hand counts at small shapes."""

import pytest

from benchmark.harness import counts

H100 = counts.PEAKS[counts.DEFAULT_PEAK]
CFG = {"hidden_size": 8, "num_hidden_layers": 2, "num_attention_heads": 2,
       "num_key_value_heads": 1, "intermediate_size": 16, "vocab_size": 10}


def _pairs_by_hand(sq, sk, q_offset, causal):
    return sum(1 for i in range(sq) for j in range(sk)
               if not causal or j <= q_offset + i)


@pytest.mark.parametrize("sq,sk,off", [(1, 1, 0), (4, 4, 0), (3, 7, 4),
                                       (5, 3, 0), (6, 4, 2), (4, 8, 0)])
@pytest.mark.parametrize("causal", [True, False])
def test_causal_pairs(sq, sk, off, causal):
    assert counts.causal_pairs(sq, sk, off, causal) == _pairs_by_hand(
        sq, sk, off, causal)


def test_attention_forward_and_backward_by_hand():
    call = {"b": 2, "sq": 4, "sk": 4, "h": 4, "hkv": 2, "d": 8,
            "causal": True, "q_offset": 0, "itemsize": 2}
    pairs = 4 + 3 + 2 + 1
    ops, nbytes = counts.attention_fwd(call)
    assert ops == 2 * 4 * pairs * (2 * 8 + 2 * 8)
    # q and out: 2 x 4 x 4 x 8 halves; k and v: 2 x 4 x 2 x 8; lse fp32.
    assert nbytes == 2 * (2 * 2 * 4 * 4 * 8 + 2 * 2 * 4 * 2 * 8) \
        + 4 * 2 * 4 * 4
    ops_b, bytes_b = counts.attention_bwd(call)
    assert ops_b == 2.5 * ops
    assert bytes_b == 2 * (4 * 2 * 4 * 4 * 8 + 4 * 2 * 4 * 2 * 8) \
        + 4 * 2 * 4 * 4


def test_roofline_share_takes_the_larger_bound():
    call = {"b": 1, "sq": 4096, "sk": 4096, "h": 32, "hkv": 8, "d": 128,
            "causal": True, "q_offset": 0, "itemsize": 2}
    ops, nbytes = counts.attention_fwd(call)
    out = counts.roofline_share([call], 1e-3, counts.attention_fwd, H100)
    assert out["bound_by"] == "operations"
    assert out["share_pct"] == pytest.approx(100 * ops / 989e12 / 1e-3)
    tiny = dict(call, sq=1, sk=1)
    low = counts.roofline_share([tiny], 1e-3, counts.attention_fwd, H100)
    assert low["bound_by"] == "bytes"


def test_model_counts_by_hand():
    # Layer matmuls: q 8x(2x4) + k, v 8x(1x4) each + o (2x4)x8 + MLP 3x8x16.
    per_layer = 8 * 8 + 2 * 8 * 4 + 8 * 8 + 3 * 8 * 16
    assert counts.layer_params(CFG) == 2 * per_layer
    assert counts.head_params(CFG) == 80
    n = 2 * per_layer + 80
    s = 6
    # 6 N plus 6 L H D (S + 1) (half of 12 L H D S, diagonal included).
    assert counts.train_flops_per_token(CFG, s) == pytest.approx(
        6 * n + 12 * 2 * 2 * 4 * (s + 1) / 2)
    # A prompt of 5: every position's layers and attention, one head.
    by_token = sum(counts.serve_token_flops(CFG, p, p == 4)
                   for p in range(5))
    assert counts.prompt_flops(CFG, 5) == pytest.approx(by_token)
    assert counts.serve_token_flops(CFG, 0, True) == (
        2 * 2 * per_layer + 4 * 2 * 2 * 4 * 1 + 2 * 80)


def test_issue_numbers_for_the_train_cell():
    from benchmark.harness import spec

    cfg = spec.load_cell("internlm2-1.8b.train4k").config
    non_embed = counts.layer_params(cfg) + counts.head_params(cfg)
    assert non_embed == pytest.approx(1.70e9, rel=0.01)
    assert counts.train_flops_per_token(cfg, 4096) == pytest.approx(
        11.4e9, rel=0.01)
