"""Glass material model: refractive index n(wavelength) (the port of
`aadff_tpu/optics/materials.py`).

Three dispersion models (Sellmeier, Schott, Cauchy from (nD, V)).  Indices
are plain host floats, as in the JAX package: wavelengths are fixed per
trace and dispersion is never differentiated.
"""
from __future__ import annotations

import dataclasses
import math

from ..constants import GLASS_NAME, MATERIAL_TABLE, SCHOTT_TABLE, SELLMEIER_TABLE


def nv_to_ab(n: float, v: float):
    """Convert (nD, Abbe V) to Cauchy (A, B)."""

    def ivs(a):
        return 1.0 / a**2

    lambdas = [656.3, 589.3, 486.1]
    b = (n - 1) / v / (ivs(lambdas[2]) - ivs(lambdas[0]))
    a = n - b * ivs(lambdas[1])
    return a, b


@dataclasses.dataclass(frozen=True)
class Material:
    """Immutable material description resolved from a name or an 'n/V' string."""

    name: str
    dispersion: str  # 'sellmeier' | 'schott' | 'naive'
    coeffs: tuple
    n: float  # nD
    v: float  # Abbe number
    a: float  # Cauchy A
    b: float  # Cauchy B
    glassname: str

    @staticmethod
    def create(name: str | None = None) -> "Material":
        name = "vacuum" if name is None else name.lower()

        entry = MATERIAL_TABLE.get(name)
        if entry is not None:
            n, v = entry
        else:
            # an 'n/V' pair, e.g. "1.83481/42.7"
            tmp = name.split("/")
            n, v = float(tmp[0]), float(tmp[1])
        a, b = nv_to_ab(n, v)

        if name in SELLMEIER_TABLE:
            return Material(name, "sellmeier", tuple(SELLMEIER_TABLE[name]), n, v, a, b, name)
        if name in SCHOTT_TABLE:
            return Material(name, "schott", tuple(SCHOTT_TABLE[name]), n, v, a, b, GLASS_NAME[name])
        return Material(name, "naive", (), n, v, a, b, name)

    def ior(self, wvln: float) -> float:
        """Refractive index at wavelength `wvln` [um] (or [nm] if >= 10)."""
        wv = wvln if wvln < 10 else wvln * 1e-3
        if self.dispersion == "sellmeier":
            k1, l1, k2, l2, k3, l3 = self.coeffs
            n2 = (
                1
                + k1 * wv**2 / (wv**2 - l1)
                + k2 * wv**2 / (wv**2 - l2)
                + k3 * wv**2 / (wv**2 - l3)
            )
            return math.sqrt(n2)
        if self.dispersion == "schott":
            a0, a1, a2, a3, a4, a5 = self.coeffs
            ws = wv**2
            n2 = a0 + a1 * ws + (a2 + (a3 + (a4 + a5 / ws) / ws) / ws) / ws
            return math.sqrt(n2)
        # Cauchy
        return self.a + self.b / (wv * 1e3) ** 2
