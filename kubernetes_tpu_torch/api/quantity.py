"""Resource quantity arithmetic.

Equivalent capability to the reference's ``resource.Quantity``
(``staging/src/k8s.io/apimachinery/pkg/api/resource``): exact arithmetic on
resource amounts written with SI-decimal ("100m", "250M", "1.5k") or
binary ("128Mi", "2Gi") suffixes, plain integers, and scientific notation.

Rather than an arbitrary-precision decimal kept through the whole
scheduler, quantities are parsed **once at the API boundary** into exact
:class:`fractions.Fraction` values and then *canonicalized to fixed-point
integer units* for all scheduling math (see ``scheduler/units.py``).  The
CPU oracle and the device scan compute on the same integers, which makes
their score parity exact instead of "close".
"""

from __future__ import annotations

import re
from fractions import Fraction
from functools import lru_cache
from functools import total_ordering

_BINARY_SUFFIXES = {
    "Ki": 2**10,
    "Mi": 2**20,
    "Gi": 2**30,
    "Ti": 2**40,
    "Pi": 2**50,
    "Ei": 2**60,
}
_DECIMAL_SUFFIXES = {
    "n": Fraction(1, 10**9),
    "u": Fraction(1, 10**6),
    "m": Fraction(1, 10**3),
    "": Fraction(1),
    "k": 10**3,
    "M": 10**6,
    "G": 10**9,
    "T": 10**12,
    "P": 10**15,
    "E": 10**18,
}

_QUANTITY_RE = re.compile(
    r"^(?P<sign>[+-]?)(?P<num>[0-9]+(?:\.[0-9]*)?|\.[0-9]+)"
    r"(?:[eE](?P<exp>[+-]?[0-9]+))?"
    r"(?P<suffix>Ki|Mi|Gi|Ti|Pi|Ei|[numkMGTPE]?)$"
)


@total_ordering
class Quantity:
    """An exact resource amount.

    Internally a :class:`fractions.Fraction`; all comparisons and arithmetic
    are exact.  ``value()`` / ``milli_value()`` round *up* like the
    reference's ``Quantity.Value()`` so that "0.5" of anything never
    under-reserves.
    """

    __slots__ = ("_frac", "_orig")

    def __init__(self, value: "Quantity | Fraction | int | float | str" = 0):
        if isinstance(value, Quantity):
            self._frac = value._frac
            self._orig = value._orig
        elif isinstance(value, str):
            self._frac = _parse(value)
            self._orig = value
        elif isinstance(value, (int, Fraction)):
            self._frac = Fraction(value)
            self._orig = None
        elif isinstance(value, float):
            # floats arrive from JSON numbers; snap to a sane decimal.
            self._frac = Fraction(str(value))
            self._orig = None
        else:
            raise TypeError(f"cannot make Quantity from {type(value)!r}")

    # -- accessors ---------------------------------------------------------
    @property
    def fraction(self) -> Fraction:
        return self._frac

    def value(self) -> int:
        """Integer value, rounded away from zero (ceil for positives)."""
        f = self._frac
        q, r = divmod(f.numerator, f.denominator)
        if r != 0 and f > 0:
            q += 1
        return q

    def milli_value(self) -> int:
        """Value in thousandths, rounded away from zero."""
        f = self._frac * 1000
        q, r = divmod(f.numerator, f.denominator)
        if r != 0 and f > 0:
            q += 1
        return q

    def is_zero(self) -> bool:
        return self._frac == 0

    # -- arithmetic --------------------------------------------------------
    def __add__(self, other: "Quantity | int") -> "Quantity":
        return Quantity(self._frac + _coerce(other))

    def __sub__(self, other: "Quantity | int") -> "Quantity":
        return Quantity(self._frac - _coerce(other))

    def __neg__(self) -> "Quantity":
        return Quantity(-self._frac)

    def __eq__(self, other) -> bool:
        try:
            return self._frac == _coerce(other)
        except TypeError:
            return NotImplemented

    def __lt__(self, other) -> bool:
        return self._frac < _coerce(other)

    def __hash__(self) -> int:
        return hash(self._frac)

    # -- serialization -----------------------------------------------------
    def __str__(self) -> str:
        if self._orig is not None:
            return self._orig
        f = self._frac
        if f.denominator == 1:
            return str(f.numerator)
        m = f * 1000
        if m.denominator == 1:
            return f"{m.numerator}m"
        # fall back to decimal with enough digits; exactness already kept
        return str(float(f))

    def __repr__(self) -> str:
        return f"Quantity({str(self)!r})"


def _coerce(v) -> Fraction:
    if isinstance(v, Quantity):
        return v._frac
    if isinstance(v, (int, Fraction)):
        return Fraction(v)
    if isinstance(v, str):
        return _parse(v)
    raise TypeError(f"cannot compare Quantity with {type(v)!r}")


@lru_cache(maxsize=8192)
def _parse(s: str) -> Fraction:
    """Memoized: clusters reuse a handful of quantity strings ("100m",
    "128Mi", …) across hundreds of thousands of objects, and Fractions are
    immutable so sharing is safe."""
    s = s.strip()
    m = _QUANTITY_RE.match(s)
    if not m:
        raise ValueError(f"invalid quantity {s!r}")
    num = Fraction(m.group("num"))
    if m.group("exp"):
        exp = int(m.group("exp"))
        num *= Fraction(10) ** exp
    suffix = m.group("suffix")
    if suffix in _BINARY_SUFFIXES:
        num *= _BINARY_SUFFIXES[suffix]
    else:
        num *= _DECIMAL_SUFFIXES[suffix]
    if m.group("sign") == "-":
        num = -num
    return num


def parse_quantity(s) -> Quantity:
    return Quantity(s)
