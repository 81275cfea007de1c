"""``MLP_KAN_FACTORY``, port of ``convkan_tpu/factory/mlp_factory.py``
(models/kans.py:481-574 of the reference): 17 keys, each a builder
``fn(layers_hidden, dropout=0.0, l1_decay=0.0, first_dropout=True,
**kwargs)`` of a ``KanMLP`` whose layer config is the key's defaults
updated by the keyword arguments that are not None (``generator``,
``device`` and ``dtype`` go to the layers)."""

from __future__ import annotations

from typing import Callable, List

from ..nn.mlp import KanMLP

_PASS = ("generator", "device", "dtype")


def _mlp(family: str, **cfg_defaults):
    def builder(layers_hidden: List[int], dropout: float = 0.0,
                l1_decay: float = 0.0, first_dropout: bool = True,
                **kwargs):
        make = {k: kwargs.pop(k) for k in _PASS if k in kwargs}
        cfg = dict(cfg_defaults)
        cfg.update({k: v for k, v in kwargs.items() if v is not None})
        return KanMLP(family, tuple(layers_hidden), dropout=dropout,
                      l1_decay=l1_decay, first_dropout=first_dropout,
                      cfg=cfg, **make)

    builder.__name__ = f"mlp_{family.lower()}"
    return builder


mlp_kan = _mlp("KAN", grid_size=5, spline_order=3, grid_range=(-1, 1))
mlp_fastkan = _mlp("FastKAN", grid_size=8, grid_range=(-2, 2),
                   use_base_update=True, spline_weight_init_scale=0.1)
mlp_legendrekan = _mlp("LegendreKAN", degree=3)
mlp_bersnsteinkan = _mlp("BersnsteinKAN", degree=3)
mlp_chebykan = _mlp("ChebyKAN", degree=3)
mlp_jacobikan = _mlp("JacobiKAN", degree=3, a=1.0, b=1.0)
mlp_gramkan = _mlp("GRAMKAN", degree=3)
mlp_besselkan = _mlp("BesselKAN", degree=3)
mlp_fibonaccikan = _mlp("FibonacciKAN", degree=3)
mlp_fourierkan = _mlp("FourierKAN", grid_size=3, add_bias=True,
                      smooth_initialization=False)
mlp_gegenbauerkan = _mlp("GegenbauerKAN", degree=3, alpha_param=0.0)
mlp_hermitekan = _mlp("HermiteKAN", degree=3)
mlp_laguerrekan = _mlp("LaguerreKAN", degree=3, alpha=0.0)
mlp_lucaskan = _mlp("LucasKAN", degree=3)
mlp_relukan = _mlp("ReLUKAN", g=1, k=1, train_ab=True)
mlp_taylorkan = _mlp("TaylorKAN", degree=3, add_bias=False)
mlp_wavkan = _mlp("WavKAN", wavelet_type="mexican_hat")

# models/kans.py:556-574, the same 17 keys in the same order
MLP_KAN_FACTORY: dict[str, Callable] = {
    "KAN": mlp_kan,
    "FastKAN": mlp_fastkan,
    "LegendreKAN": mlp_legendrekan,
    "BersnsteinKAN": mlp_bersnsteinkan,
    "BesselKAN": mlp_besselkan,
    "ChebyKAN": mlp_chebykan,
    "FibonacciKAN": mlp_fibonaccikan,
    "FourierKAN": mlp_fourierkan,
    "GegenbauerKAN": mlp_gegenbauerkan,
    "GRAMKAN": mlp_gramkan,
    "HermiteKAN": mlp_hermitekan,
    "JacobiKAN": mlp_jacobikan,
    "LaguerreKAN": mlp_laguerrekan,
    "LucasKAN": mlp_lucaskan,
    "ReLUKAN": mlp_relukan,
    "TaylorKAN": mlp_taylorkan,
    "WavKAN": mlp_wavkan,
}
