"""Host-side planning of the CUDA kernels, on the CPU: how the exit-head
kernel cuts rows and the vocabulary over blocks, and which variant each
kernel takes for a dtype, width, alignment and layout. The kernels
themselves run only on the card (chip_smoke.py); these are the pure
functions that pick their launches.
"""
import pytest
import torch

from repro_torch.kernels._build import rows_aligned
from repro_torch.kernels.exit_confidence import kernel as exit_kernel
from repro_torch.kernels.exit_confidence.kernel import (exit_variant, plan,
                                                        tile_shape)
from repro_torch.kernels.flash_attention import kernel as attn_kernel
from repro_torch.kernels.flash_attention.kernel import (
    attention_backward_tile, attention_backward_variant, attention_variant,
    backward_workspace_bytes, dq_block_tiles, dq_key_splits, dq_split_tiles)
from repro_torch.kernels.wkv6.kernel import (wkv6_backward_variant,
                                             wkv6_variant)

H100_SMS = 132
GRID_Y_Z = 65535
VARIANTS = exit_kernel.VARIANTS


PLAN_CASES = [(variant, g, m, v)
              for variant in VARIANTS for g in (1, 12) for m in (1, 32, 1024)
              for v in (2, 40, 64, 65, 32000, 32064, 65536, 151936)
              if variant != "small_head" or v <= exit_kernel.SMALL_VOCAB]


@pytest.mark.parametrize("variant,g,m,v", PLAN_CASES)
def test_every_column_and_row_lands_in_exactly_one_block(variant, g, m, v):
    pl = plan(g, m, v, H100_SMS, *tile_shape(variant, m))
    cols = pl.cols_per_split
    col_tile = tile_shape(variant, m)[1]
    assert cols % col_tile == 0
    # splits [i*cols, (i+1)*cols) clipped to V: each column in exactly one
    owner = torch.zeros(v, dtype=torch.int64)
    for i in range(pl.splits):
        owner[i * cols:min(v, (i + 1) * cols)] += 1
    assert (owner == 1).all()
    assert (pl.splits - 1) * cols < v         # no empty split
    # row tiles of rows_per_tile over M: each row in exactly one tile
    tiles = -(-m // pl.rows_per_tile)
    rows = torch.zeros(m, dtype=torch.int64)
    for t in range(tiles):
        rows[t * pl.rows_per_tile:(t + 1) * pl.rows_per_tile] += 1
    assert (rows == 1).all()
    # the grid: (row tiles, splits, G), y and z within CUDA's limits
    assert 1 <= pl.splits <= GRID_Y_Z and g <= GRID_Y_Z


@pytest.mark.parametrize("sms", [1, 66, 132])
def test_splits_cover_the_sms_without_exceeding_the_columns(sms):
    """The vocabulary is split until the grid fills the SMs' block slots,
    never into more splits than column tiles."""
    for m in (32, 1024):
        rows, cols, per_sm = tile_shape("tensor_core", m)
        pl = plan(1, m, 65536, sms, rows, cols, per_sm)
        row_tiles = -(-m // rows)
        assert pl.splits <= 65536 // cols
        assert pl.splits * row_tiles <= max(sms * per_sm, row_tiles)
    # a V of one column tile, or a grid full from row tiles: no split
    assert plan(1, 32, 100, sms, 32, 128, 2).splits == 1
    assert plan(12, 100000, 65536, sms, 8, 256, 2).splits == 1


def test_splits_stay_under_the_grid_limit():
    pl = plan(1, 1, 10 ** 8, 10 ** 6, 32, 128, 2)
    assert pl.splits <= GRID_Y_Z
    assert pl.splits * pl.cols_per_split >= 10 ** 8


def test_tensor_core_tiles_follow_the_row_count():
    assert tile_shape("tensor_core", 1)[:2] == (32, 128)
    assert tile_shape("tensor_core", 32)[:2] == (32, 128)
    assert tile_shape("tensor_core", 33)[:2] == (128, 128)
    assert tile_shape("tensor_core", 1024)[:2] == (128, 128)
    assert tile_shape("cuda_core", 32)[:2] == (8, 256)


@pytest.mark.parametrize("rows,tile", [
    (1, "mma_sync"), (17, "mma_sync"), (32, "mma_sync"), (33, "wgmma"),
    (544, "wgmma"), (1024, "wgmma")])
def test_tensor_core_tile_counted_per_launch(rows, tile):
    """The tile a tensor_core launch is counted under is the one its row
    count takes (the mma.sync tile up to 32 rows a group, wgmma above;
    M = 32 x 17 = 544 is the rwkv6 scan edge of a 17-row tail), and every
    tile of both exit kernels and of attention's backward has its
    counter."""
    from repro_torch.kernels import tile_launch_counts
    assert exit_kernel.tc_tile(rows) == tile
    assert tile_shape("tensor_core", rows)[0] == (
        exit_kernel.TC_SMALL_ROWS if tile == "mma_sync" else exit_kernel.TC_ROWS)
    assert sorted(tile_launch_counts()) == sorted(
        [f"{k}/tensor_core/{t}" for k in ("exit_confidence",
                                          "exit_confidence_fused")
         for t in exit_kernel.TC_TILES]
        + [f"flash_attention_backward/tensor_core/{t}"
           for t in attn_kernel.BACKWARD_TILES])


BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("rows,d,v,tile,row_tiles", [
    (28, 2048, 151936, "mma_sync", 1),     # qwen3-1.7b, B = 1: 28 exits
    (224, 2048, 151936, "wgmma", 2),       # B = 8: 128 + a partial 96
    (32, 2560, 65536, "mma_sync", 1),      # rwkv6-3b, B = 1: 32 exits
    (256, 2560, 65536, "wgmma", 2),        # B = 8
    (38, 2048, 32000, "wgmma", 1),         # zamba2-1.2b, B = 1: 38 > 32
    (304, 2048, 32000, "wgmma", 3),        # B = 8: 128 + 128 + a partial 48
    (16, 4096, 32064, "mma_sync", 1),      # phi3.5-moe at 16 layers, B = 1
    (128, 4096, 32064, "wgmma", 1),        # B = 8
])
def test_decode_step_exit_launch(rows, d, v, tile, row_tiles):
    """A decode edge step scores L x B exit rows at the LM head in one
    launch: bf16 aligned rows take the tensor-core variant, the mma.sync
    tile up to 32 rows and wgmma above (224 = 128 + 96 leaves a partial
    row tile), and the plan covers every column of the vocabulary once."""
    assert exit_variant(BF16, d, v, True) == "tensor_core"
    assert exit_kernel.tc_tile(rows) == tile
    pl = plan(1, rows, v, H100_SMS, *tile_shape("tensor_core", rows))
    assert -(-rows // pl.rows_per_tile) == row_tiles
    assert pl.cols_per_split % exit_kernel.TC_COLS == 0
    assert (pl.splits - 1) * pl.cols_per_split < v <= \
        pl.splits * pl.cols_per_split
    assert exit_variant(F32, d, v, True) == "cuda_core"   # the f32 cut


@pytest.mark.parametrize("m", [32, 38, 304, 512, 1216])
@pytest.mark.parametrize("v,last_cols", [(32000, 128), (32064, 64)])
def test_last_column_tile_of_the_new_vocabularies(m, v, last_cols):
    """zamba2's vocabulary 32000 is 250 whole 128-column tiles;
    phi3.5-moe's 32064 = 250 x 128 + 64, the first vocabulary whose last
    column tile is partial: the last split ends at V and its last tile
    holds 64 live columns (the source bounds columns by min(V, ...)),
    and no split starts past V."""
    assert exit_variant(BF16, 4096, v, True) == "tensor_core"
    rows, cols, per_sm = tile_shape("tensor_core", m)
    pl = plan(1, m, v, H100_SMS, rows, cols, per_sm)
    col_tiles = -(-v // exit_kernel.TC_COLS)
    assert col_tiles == 250 + (last_cols < exit_kernel.TC_COLS)
    assert v - (col_tiles - 1) * exit_kernel.TC_COLS == last_cols
    starts = [i * pl.cols_per_split for i in range(pl.splits)]
    assert starts[-1] < v <= starts[-1] + pl.cols_per_split
    tiles_in_last = -(-(v - starts[-1]) // exit_kernel.TC_COLS)
    assert v - (starts[-1] + (tiles_in_last - 1) * exit_kernel.TC_COLS) == \
        last_cols
    assert sum(min(v, s + pl.cols_per_split) - s for s in starts) == v


@pytest.mark.parametrize("dtype,aligned,want", [
    (BF16, True, "tensor_core"), (BF16, False, "cuda_core"),
    (F32, True, "cuda_core")])
def test_qwen3_prefill_attention_variant(dtype, aligned, want):
    """qwen3-1.7b's prefill attention: head dim 128, 16 query and 8 KV
    heads (GQA resolved by index in the kernel)."""
    q = torch.zeros((8, 64, 16, 128), dtype=dtype).transpose(1, 2)
    assert rows_aligned(q)
    assert attention_variant(dtype, 128, aligned) == want


@pytest.mark.parametrize("dtype,d,v,aligned,want", [
    (BF16, 768, 2, True, "small_head"),          # ElasticBERT exits
    (F32, 768, 2, True, "small_head"),
    (BF16, 768, 64, True, "small_head"),
    (BF16, 768, 65, True, "cuda_core"),          # odd V
    (BF16, 2560, 65536, True, "tensor_core"),    # the rwkv6-3b LM head
    (BF16, 2560, 151936, True, "tensor_core"),
    (BF16, 64, 40, True, "small_head"),
    (BF16, 2560, 65536, False, "cuda_core"),     # unaligned rows
    (BF16, 768, 2, False, "cuda_core"),
    (BF16, 769, 2, True, "cuda_core"),           # D % 8 (a folded bias)
    (BF16, 2564, 65536, True, "cuda_core"),
    (F32, 2560, 65536, True, "cuda_core"),       # f32 keeps the f32 walk
    (F32, 770, 2, True, "cuda_core"),            # D % 4
    (BF16, 4100, 2, True, "cuda_core"),          # D % 8
    (BF16, 4096, 2, True, "small_head"),         # any D: the row streams
    (F32, 1028, 2, True, "small_head"),
    (BF16, 4096, 1024, True, "tensor_core"),
    (F32, 2560, 64, True, "small_head"),
])
def test_exit_variant(dtype, d, v, aligned, want):
    assert exit_variant(dtype, d, v, aligned) == want


@pytest.mark.parametrize("dtype,d,v,aligned,want", [
    (BF16, 1024, 256206, True, "tensor_core"),   # seamless: even, V % 8 = 6
    (F32, 1024, 256206, True, "cuda_core"),
    (BF16, 1024, 256206, False, "cuda_core"),
    (BF16, 1024, 256205, True, "cuda_core"),     # odd V: rows off 4 bytes
    (BF16, 1024, 256207, True, "cuda_core"),
    (BF16, 1536, 151936, True, "tensor_core"),   # qwen2-vl-2b's head
    (F32, 1536, 151936, True, "cuda_core"),
    (BF16, 1024, 66, True, "tensor_core"),       # past the small head, even
    (BF16, 1024, 62, True, "small_head"),
])
def test_exit_variant_at_an_even_vocabulary_off_8(dtype, d, v, aligned, want):
    """An even V that is not a multiple of 8 takes the tensor-core variant
    in bf16 (w staged in 4-byte pieces); an odd V, f32 or unaligned rows
    keep the CUDA-core walk."""
    assert exit_variant(dtype, d, v, aligned) == want


@pytest.mark.parametrize("m", [8, 32, 192, 1536])
def test_plan_at_v_256206_covers_every_column_once(m):
    """seamless's head: 2002 column tiles, the last holding 78 columns
    (256206 = 2001 x 128 + 78): every column lands in exactly one split,
    the last split ends at V, and no split starts past it."""
    v = 256206
    rows, cols, per_sm = tile_shape("tensor_core", m)
    pl = plan(1, m, v, H100_SMS, rows, cols, per_sm)
    assert pl.cols_per_split % exit_kernel.TC_COLS == 0
    owner = torch.zeros(v, dtype=torch.int64)
    for i in range(pl.splits):
        owner[i * pl.cols_per_split:min(v, (i + 1) * pl.cols_per_split)] += 1
    assert (owner == 1).all()
    assert (pl.splits - 1) * pl.cols_per_split < v
    assert -(-v // exit_kernel.TC_COLS) == 2002
    assert v - 2001 * exit_kernel.TC_COLS == 78
    assert exit_kernel.tc_tile(m) == ("mma_sync" if m <= 32 else "wgmma")


@pytest.mark.parametrize("dtype,d,aligned,want", [
    (BF16, 64, True, "tensor_core"),             # ElasticBERT-12, seamless
    (BF16, 128, True, "tensor_core"),            # qwen2-vl-2b (12/2 GQA)
    (BF16, 64, False, "cuda_core"),
    (BF16, 128, False, "cuda_core"),
    (BF16, 16, True, "cuda_core"),
    (BF16, 32, True, "cuda_core"),
    (BF16, 48, True, "cuda_core"),
    (BF16, 96, True, "cuda_core"),
    (F32, 64, True, "cuda_core"),
    (F32, 128, True, "cuda_core"),
])
def test_attention_variant(dtype, d, aligned, want):
    assert attention_variant(dtype, d, aligned) == want


@pytest.mark.parametrize("dtype,d,aligned,want", [
    (BF16, 64, True, "tensor_core"),     # seamless's encoder, zamba2
    (BF16, 128, True, "tensor_core"),    # qwen3, phi3.5-moe, qwen2-vl
    (BF16, 64, False, "cuda_core"),      # a row of q/k/v/o/dO/dq/dk/dv off
    (BF16, 128, False, "cuda_core"),
    (BF16, 32, True, "cuda_core"),
    (BF16, 96, True, "cuda_core"),
    (F32, 64, True, "cuda_core"),        # ElasticBERT-12's f32 training
    (F32, 32, True, "cuda_core"),        # the CLI testbed
    (F32, 128, False, "cuda_core"),
])
def test_attention_backward_variant(dtype, d, aligned, want):
    """The backward kernel's variant: the forward's rule, over the
    alignment of every row it reads and writes."""
    assert attention_backward_variant(dtype, d, aligned) == want


# the backward's training shapes (PERF.md §6): (b, hq, hkv, sq, skv, d)
SEAMLESS_ENCODER = (8, 16, 16, 4096, 4096, 64)
SEAMLESS_CROSS = (8, 16, 16, 32, 4096, 64)
SEAMLESS_DECODER = (8, 16, 16, 32, 32, 64)
BACKWARD_SHAPES = {
    "seamless_encoder": SEAMLESS_ENCODER,
    "seamless_cross": SEAMLESS_CROSS,
    "seamless_decoder": SEAMLESS_DECODER,
    "qwen3": (16, 16, 8, 64, 64, 128),
    "phi35": (16, 32, 8, 64, 64, 128),
    "qwen2vl": (16, 12, 2, 64, 64, 128),
    "zamba2": (16, 32, 32, 64, 64, 64),
    "elasticbert_f32": (64, 12, 12, 64, 64, 64),
    "elasticbert_tp2_f32": (64, 6, 6, 64, 64, 64),
    # chip_smoke.py's bf16 window cases, either side of WGMMA_MIN_KEYS
    "window_d64": (2, 8, 4, 300, 300, 64),
    "window_d128": (2, 4, 2, 300, 300, 128),
    "gqa_causal_d128": (2, 8, 2, 130, 130, 128),
}


@pytest.mark.parametrize("shape,dtype,aligned,want", [
    ("seamless_encoder", BF16, True, "wgmma"),
    ("seamless_cross", BF16, True, "wgmma"),
    ("seamless_decoder", BF16, True, "mma_sync"),
    ("qwen3", BF16, True, "mma_sync"),
    ("phi35", BF16, True, "mma_sync"),
    ("qwen2vl", BF16, True, "mma_sync"),
    ("zamba2", BF16, True, "mma_sync"),
    ("window_d64", BF16, True, "wgmma"),
    ("window_d128", BF16, True, "wgmma"),
    ("gqa_causal_d128", BF16, True, "mma_sync"),
    ("elasticbert_f32", F32, True, None),
    ("elasticbert_tp2_f32", F32, True, None),
    ("seamless_encoder", F32, True, None),       # f32: cuda_core, no tile
    ("seamless_encoder", BF16, False, None),     # rows off 16 bytes
    ("qwen3", BF16, False, None),
])
def test_attention_backward_tile(shape, dtype, aligned, want):
    """The tensor_core variant's tile from the shapes alone: wgmma from
    WGMMA_MIN_KEYS keys on (seamless's 4096, the 300-key windows at
    either head dim), mma_sync at the 32-, 64- and 130-token shapes; no
    tile where the variant is cuda_core."""
    b, hq, hkv, sq, skv, d = BACKWARD_SHAPES[shape]
    got = attention_backward_tile(dtype, d, aligned, sq, skv)
    assert got == want
    assert (got is None) == (attention_backward_variant(dtype, d, aligned)
                             == "cuda_core")


@pytest.mark.parametrize("shape,want", [
    ("seamless_encoder", 1), ("seamless_cross", 3), ("seamless_decoder", 1),
    ("qwen3", 1), ("zamba2", 1), ("elasticbert_f32", 1)])
def test_dq_key_splits(shape, want):
    """One split wherever the dQ grid already fills the card (always at
    the encoder) or there is one KV tile (the decoder's 32 keys); a few
    at seamless's cross-attention, whose 128 blocks leave SMs idle; never
    more splits than KV tiles."""
    b, hq, _, sq, skv, _ = BACKWARD_SHAPES[shape]
    splits = dq_key_splits(b * hq, sq, skv, H100_SMS)
    assert splits == want
    blocks = b * hq * -(-sq // attn_kernel.WG_ROWS)
    tiles = -(-skv // attn_kernel.WG_KV)
    assert (splits > 1) == (blocks < H100_SMS and tiles > 1)
    assert splits <= tiles


@pytest.mark.parametrize("bh,sq,skv", [(1, 1, 1), (1, 5, 64), (2, 1, 65),
                                       (131, 128, 8192), (132, 128, 64),
                                       (4, 200, 100000)])
def test_dq_key_splits_bounds(bh, sq, skv):
    splits = dq_key_splits(bh, sq, skv, H100_SMS)
    assert 1 <= splits <= max(1, -(-skv // attn_kernel.WG_KV))
    assert splits <= 65535


def _visible_keys(sq, skv, rows, causal, window):
    """The keys some query row of ``rows`` sees (global positions: row r
    at skv - sq + r), by brute force."""
    keys = set()
    for r in rows:
        pos = r + skv - sq
        keys.update(k for k in range(skv)
                    if (not causal or k <= pos)
                    and (not window or k > pos - window))
    return keys


@pytest.mark.parametrize("sq,skv,causal,window", [
    (300, 300, True, 0),          # causal
    (300, 300, True, 48),         # sliding window
    (77, 333, True, 0),           # suffix queries
    (200, 900, True, 100),        # suffix queries in a window
    (150, 40, True, 0),           # rows without keys
    (32, 4096, False, 0),         # seamless's cross-attention
    (260, 700, False, 0),
])
@pytest.mark.parametrize("splits", [1, 2, 3, 5, 64])
def test_dq_splits_cover_the_key_range_once(sq, skv, causal, window,
                                             splits):
    """Every wgmma dQ block's KV tiles are those that hold a key its rows
    may see, and its splits walk them in contiguous ranges, in split
    order, each tile exactly once (an empty range where there are more
    splits than tiles)."""
    rows_per_block, keys = attn_kernel.WG_ROWS, attn_kernel.WG_KV
    for r0 in range(0, sq, rows_per_block):
        t_lo, t_hi = dq_block_tiles(sq, skv, r0, causal, window)
        seen = _visible_keys(sq, skv, range(r0, min(r0 + rows_per_block, sq)),
                             causal, window)
        if seen:
            assert (t_lo, t_hi) == (min(seen) // keys, max(seen) // keys + 1)
        else:
            assert t_lo == t_hi
        walked = []
        for split in range(splits):
            first, last = dq_split_tiles(t_lo, t_hi, splits, split)
            assert t_lo <= first <= last <= t_hi
            assert not walked or first == walked[-1] + 1 or first == last
            walked += range(first, last)
        assert walked == list(range(t_lo, t_hi))


@pytest.mark.parametrize("shape,tile,want", [
    ("seamless_encoder", "wgmma", 0),
    ("seamless_cross", "wgmma", 3 * 8 * 16 * 32 * 64 * 4),
    ("seamless_cross", "mma_sync", 0),
    ("zamba2", "wgmma", 0),
    ("qwen3", "mma_sync", 0),
    ("elasticbert_f32", None, 0),
])
def test_backward_workspace_bytes(shape, tile, want):
    """The dQ partials of the wgmma tile's key splits, S x (B, Hq, Sq, d)
    float32: 0 wherever S = 1 or the tile is another."""
    b, hq, _, sq, skv, d = BACKWARD_SHAPES[shape]
    assert backward_workspace_bytes(b, hq, sq, d, tile, skv, H100_SMS) \
        == want


def test_row_alignment_reads_pointer_and_strides():
    """A misaligned row stride or data pointer makes rows unaligned; a
    stride of a length-1 axis does not count."""
    buf = torch.zeros(4 * 80 + 8, dtype=BF16)
    assert rows_aligned(buf[:320].view(4, 80))
    assert not rows_aligned(buf[1:321].view(4, 80))          # pointer + 2 B
    assert not rows_aligned(buf[:4 * 81].view(4, 81)[:, :80])  # stride 81
    assert rows_aligned(buf[:81].view(1, 81)[:, :80])         # one row
    x = torch.zeros(2, 64, 12, 64, dtype=BF16)                # (B, S, H, d)
    assert rows_aligned(x.transpose(1, 2))                    # as attn passes
    assert not rows_aligned(torch.zeros(3, 5, 2, dtype=F32)[:, :, :1])
    assert rows_aligned(torch.zeros(2, 8, dtype=BF16), torch.zeros(2, 8,
                                                                 dtype=BF16))
    assert not rows_aligned(torch.zeros(2, 8, dtype=BF16),
                            torch.zeros(2, 9, dtype=BF16))


@pytest.mark.parametrize("offset,row", [(1, 80), (0, 84), (8, 80)])
def test_unaligned_rows_choose_the_cuda_core_variants(offset, row):
    """Rows that start off 16 bytes (a pointer 2 bytes in, a row stride of
    84 elements) take the cuda_core variants; an 8-element offset keeps
    them aligned."""
    buf = torch.zeros(8192, dtype=BF16)
    h = buf[offset:offset + 4 * row].view(4, row)[:, :80]
    q = buf[offset:offset + 64 * row].view(1, 1, 64, row)[..., :64]
    ok = offset % 8 == 0 and row % 8 == 0
    assert rows_aligned(h) is ok and rows_aligned(q) is ok
    want = ("tensor_core", "tensor_core") if ok else ("cuda_core", "cuda_core")
    assert (exit_variant(BF16, 80, 65536, rows_aligned(h)),
            attention_variant(BF16, 64, rows_aligned(q))) == want


def _wkv6_inputs(layout, dtype, b=2, h=3, t=5, d=64):
    """r, k, v in ``dtype`` and w in float32, (B, H, T, d), in one of the
    layouts the WKV6 kernel is handed."""
    def one(dt):
        if layout == "serving":       # (B, S, H, hd) -> (B, H, S, hd) view
            return torch.zeros((b, t, h, d), dtype=dt).transpose(1, 2)
        if layout == "contiguous":
            return torch.zeros((b, h, t, d), dtype=dt)
        if layout == "offset1":       # one element into its buffer
            n = b * h * t * d
            return torch.zeros(n + 1, dtype=dt)[1:].view(b, h, t, d)
        if layout == "feature_stride2":
            return torch.zeros((b, h, t, 2 * d), dtype=dt)[..., ::2]
        raise ValueError(layout)
    return one(dtype), one(dtype), one(dtype), one(F32)


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("layout,want", [
    ("serving", "vec16"),             # the rwkv6-3b time_mix views
    ("contiguous", "vec16"),
    ("offset1", "scalar"),            # rows off 16 bytes
    ("feature_stride2", "scalar"),    # rows_aligned holds, stride(-1) != 1
])
def test_wkv6_variant(layout, want, dtype):
    """The same answer for float32 and bfloat16 r/k/v: the serving layout
    takes the cp.async rows, anything else the element path."""
    r, k, v, w = _wkv6_inputs(layout, dtype)
    assert wkv6_variant(r, k, v, w) == want


def test_wkv6_variant_needs_every_input_and_whole_16_byte_rows():
    r, k, v, w = _wkv6_inputs("serving", BF16)
    assert rows_aligned(*_wkv6_inputs("feature_stride2", BF16))
    off = _wkv6_inputs("offset1", BF16)
    for i in range(4):                # one unaligned input is enough
        args = [r, k, v, w]
        args[i] = off[i]
        assert wkv6_variant(*args) == "scalar"
    # row lengths: 48 bf16 = 96 bytes and 40 f32 = 160 bytes are whole
    # 16-byte pieces; 36 bf16 = 72 bytes and 2 f32 = 8 bytes are not
    assert wkv6_variant(*_wkv6_inputs("contiguous", BF16, d=48)) == "vec16"
    assert wkv6_variant(*_wkv6_inputs("contiguous", F32, d=40)) == "vec16"
    assert wkv6_variant(*_wkv6_inputs("contiguous", BF16, d=36)) == "scalar"
    assert wkv6_variant(*_wkv6_inputs("contiguous", F32, d=2)) == "scalar"


def _dy(layout, b=2, h=3, t=5, d=64):
    """y's cotangent (B, H, T, dv) float32 in one of the layouts autograd
    hands the backward: y's own (B, T, H, dv) memory, contiguous, or
    rows off 16 bytes."""
    return _wkv6_inputs(layout, F32, b, h, t, d)[0]


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("layout,dy_layout,want", [
    ("serving", "serving", "vec16"),      # time_mix's views, y's layout
    ("serving", "contiguous", "vec16"),
    ("contiguous", "offset1", "scalar"),  # dy alone off 16 bytes
    ("offset1", "serving", "scalar"),
    ("feature_stride2", "contiguous", "scalar"),
])
def test_wkv6_backward_variant(layout, dy_layout, want, dtype):
    """The backward's variant is the forward's rule over r, k, v, w and
    dy: vec16 only when all five have whole 16-byte rows."""
    r, k, v, w = _wkv6_inputs(layout, dtype)
    assert wkv6_backward_variant(r, k, v, w, _dy(dy_layout)) == want


@pytest.mark.parametrize("dtype,d,want", [
    (BF16, 48, "vec16"),      # 96-byte r/k/v rows, 192-byte dy rows
    (BF16, 8, "vec16"),
    (BF16, 36, "scalar"),     # 72 bytes: not whole 16-byte pieces
    (F32, 40, "vec16"),
    (F32, 2, "scalar"),       # 8 bytes, dy's too
])
def test_wkv6_backward_variant_row_lengths(dtype, d, want):
    """Contiguous rows of ``d`` features take vec16 only when r/k/v's (in
    their dtype) and dy's (float32) are whole 16-byte pieces."""
    r, k, v, w = _wkv6_inputs("contiguous", dtype, d=d)
    assert wkv6_backward_variant(r, k, v, w, _dy("contiguous", d=d)) == want
