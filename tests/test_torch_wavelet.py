"""Port parity for the WavKAN mother wavelets
(convkan_tpu_torch/basis/wavelet.py) against convkan_tpu/basis/wavelet.py
in float64, on random points and at z = 0, |z| = 0.5 and |z| = 1 (Meyer's
breakpoints): max |diff| <= 1e-12."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convkan_tpu_torch.basis import wavelet as tw

# the JAX package's basis/__init__ exports a function named ``wavelet``
jw = importlib.import_module("convkan_tpu.basis.wavelet")

torch.set_num_threads(1)

SPECIAL = np.array([0.0, 0.5, -0.5, 1.0, -1.0, 0.25, 0.75, -0.75, 2.0])


def _points(seed, shape=(4, 3, 5, 6)):
    z = np.random.RandomState(seed).uniform(-4, 4, shape)
    z.reshape(-1)[:len(SPECIAL)] = SPECIAL
    return z


def test_wavelet_types_match():
    assert tw.WAVELET_TYPES == jw.WAVELET_TYPES


@pytest.mark.parametrize("wavelet_type", jw.WAVELET_TYPES)
@pytest.mark.parametrize("channel_axis", [-1, 1])
def test_wavelets_match_jax_f64(wavelet_type, channel_axis):
    z = _points(len(wavelet_type) + channel_axis)
    want = np.asarray(jw.wavelet(jnp.asarray(z), wavelet_type,
                                 channel_axis=channel_axis))
    got = tw.wavelet(torch.from_numpy(z), wavelet_type,
                     channel_axis=channel_axis).numpy()
    assert got.dtype == np.float64 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("n", [1, 2, 3, 8, 128])
def test_hamming_window_matches_jax(n):
    np.testing.assert_array_equal(tw.hamming_window(n), jw.hamming_window(n))
    if n > 1:   # and torch's own symmetric window, in float64
        np.testing.assert_allclose(
            tw.hamming_window(n),
            torch.hamming_window(n, periodic=False, dtype=torch.float64),
            rtol=0, atol=1e-15)


def test_shannon_windows_the_channel_axis_and_needs_it():
    z = torch.from_numpy(_points(0, (2, 5)))
    got = tw.wavelet(z, "shannon", channel_axis=-1)
    want = torch.sinc(z / np.pi) * torch.from_numpy(tw.hamming_window(5))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(ValueError):
        tw.wavelet(z, "shannon")
    with pytest.raises(ValueError):
        tw.wavelet(z, "haar")
