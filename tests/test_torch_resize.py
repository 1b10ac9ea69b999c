"""The squash resize of the detector's frames: the op
``sln_amodal::resize_bilinear_u8``'s plain path against Pillow's
``Image.resize(BILINEAR)``, its coefficient tables against a loop
transcription of Pillow's ``precompute_coeffs``, and ``mold_inputs``'
packing. The CUDA kernel is held to PIL on the card
(``tests/test_torch_cuda.py``)."""

import math

import numpy as np
import pytest
import torch
from PIL import Image

from sln_amodal_tpu_torch.config import Config
from sln_amodal_tpu_torch.ops.resize import (PRECISION_BITS, coefficients,
                                             resize_bilinear_plain)
from sln_amodal_tpu_torch.ops.resize_cuda import band_rows, resize_bilinear_u8
from sln_amodal_tpu_torch.utils.image import mold_inputs

# (height, width): the benchmark's COCO sizes, the model's own frame, and
# D2SA's frame, which the resize scales down
TRAFFIC = [(480, 640), (640, 480), (427, 640), (640, 427), (375, 500), (500, 375)]
SIZES = TRAFFIC + [(1024, 1024), (1440, 1920)]


def pil(image, out_h, out_w):
    return np.asarray(Image.fromarray(image).resize((out_w, out_h), Image.BILINEAR))


def pillow_coefficients(in_len, out_len):
    """``precompute_coeffs`` and ``normalize_coeffs_8bpc`` of Pillow's
    ``libImaging/Resample.c`` (bilinear, the whole input as the box), line
    by line."""
    scale = filterscale = in_len / out_len
    if filterscale < 1.0:
        filterscale = 1.0
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    rows = []
    for xx in range(out_len):
        center = (xx + 0.5) * scale
        ww, ss = 0.0, 1.0 / filterscale
        xmin = int(center - support + 0.5)
        if xmin < 0:
            xmin = 0
        xmax = int(center + support + 0.5)
        if xmax > in_len:
            xmax = in_len
        xmax -= xmin
        k = []
        for x in range(xmax):
            arg = abs((x + xmin - center + 0.5) * ss)
            w = 1.0 - arg if arg < 1.0 else 0.0
            k.append(w)
            ww += w
        k = [w / ww if ww != 0.0 else w for w in k] + [0.0] * (ksize - xmax)
        fixed = [int(-0.5 + w * (1 << PRECISION_BITS)) if w < 0
                 else int(0.5 + w * (1 << PRECISION_BITS)) for w in k]
        rows.append([xmin, xmax] + fixed)
    return np.array(rows, np.int32)


@pytest.mark.parametrize("in_len,out_len", [
    (640, 1024), (480, 1024), (427, 1024), (375, 1024), (500, 1024), (1024, 1024),
    (1440, 1024), (1920, 1024), (53, 90), (37, 11)])
def test_coefficients_are_pillows(in_len, out_len):
    np.testing.assert_array_equal(coefficients(in_len, out_len),
                                  pillow_coefficients(in_len, out_len))


@pytest.mark.parametrize("h,w,out_h,out_w", [(h, w, 1024, 1024) for h, w in SIZES]
                         + [(37, 53, 11, 90)])
def test_plain_resize_is_pils(h, w, out_h, out_w):
    """The op's plain path (square outputs, through the op as the detector
    calls it) and the plain resize (any output) equal Pillow's bit for bit."""
    image = np.random.RandomState(h * w).randint(0, 256, (h, w, 3), np.uint8)
    if out_h == out_w:
        packed, table, _ = mold_inputs([image], Config(image_size=out_h))
        got = resize_bilinear_u8(torch.from_numpy(packed), torch.from_numpy(table), out_h)[0]
    else:
        got = resize_bilinear_plain(torch.from_numpy(image), out_h, out_w)
    np.testing.assert_array_equal(got.numpy(), pil(image, out_h, out_w))


def test_mixed_batch_is_pils_per_image():
    """A batch of 8 of mixed sizes, packed by ``mold_inputs``, through one
    call of the op."""
    rng = np.random.RandomState(8)
    images = [rng.randint(0, 256, SIZES[i] + (3,), np.uint8) for i in range(8)]
    packed, table, windows = mold_inputs(images, Config(image_size=1024))
    got = resize_bilinear_u8(torch.from_numpy(packed), torch.from_numpy(table), 1024)
    assert got.shape == (8, 1024, 1024, 3) and got.dtype == torch.uint8
    for image, frame in zip(images, got):
        np.testing.assert_array_equal(frame.numpy(), pil(image, 1024, 1024))
    assert windows.tolist() == [[0, 0, 1024, 1024]] * 8


def test_mold_inputs_packs_raw_frames():
    rng = np.random.RandomState(3)
    images = [rng.randint(0, 256, (5, 7, 3), np.uint8), rng.randint(0, 256, (2, 3, 3), np.uint8)]
    packed, table, windows = mold_inputs(images, Config(image_size=64))
    assert packed.dtype == np.uint8 and table.dtype == np.int64
    assert table.tolist() == [[0, 5, 7], [105, 2, 3]]
    np.testing.assert_array_equal(packed, np.concatenate([im.reshape(-1) for im in images]))
    assert windows.tolist() == [[0, 0, 64, 64]] * 2
    with pytest.raises(ValueError, match=r"\[H, W, 3\]"):
        mold_inputs([np.zeros((4, 4), np.uint8)], Config(image_size=64))


@pytest.mark.parametrize("in_len,band", [(480, 8), (1024, 8), (1440, 8), (1440, 1), (37, 3)])
def test_band_rows_is_the_widest_band(in_len, band):
    """The kernel's shared rows: the most input rows any band of output
    rows reads, counted row by row."""
    table = coefficients(in_len, 1024)
    want = max(max(table[y, 0] + table[y, 1] for y in range(y0, min(y0 + band, 1024)))
               - table[y0, 0] for y0 in range(0, 1024, band))
    assert band_rows(in_len, 1024, band) == want
