"""Kubernetes resource-quantity parsing — the port's own copy of
``kubernetes_rescheduling_tpu.core.quantities`` (host-side, no tensors).

Same semantics as the reference's converters (reference
unit_convertion.py:1-32), extended to the full Kubernetes quantity grammar
(decimal SI suffixes, exponent notation):

- CPU → integer millicores: ``"53m" -> 53``, ``"2" -> 2000``,
  ``"1500000n" -> 2`` (rounded), ``"1500u" -> 2`` (rounded).
- Memory → integer bytes: binary suffixes Ki..Ei, decimal k/M/G/T/P/E and
  bare/exponent numbers.
"""

from __future__ import annotations

_BINARY_UNITS = {
    "Ki": 1024,
    "Mi": 1024**2,
    "Gi": 1024**3,
    "Ti": 1024**4,
    "Pi": 1024**5,
    "Ei": 1024**6,
}

# Kubernetes decimal SI suffixes (resource.Quantity): lowercase k, uppercase rest.
_DECIMAL_UNITS = {
    "k": 10**3,
    "M": 10**6,
    "G": 10**9,
    "T": 10**12,
    "P": 10**15,
    "E": 10**18,
}


def cpu_to_millicores(cpu: str | int | float) -> int:
    """Parse a CPU quantity into integer millicores.

    Mirrors reference unit_convertion.py:1-13: ``m`` passes through (truncated
    to int), ``n`` divides by 1e6 (rounded), ``u`` divides by 1e3 (rounded),
    a bare number is cores and multiplies by 1000 (rounded).
    """
    s = str(cpu).strip()
    if not s:
        raise ValueError("empty CPU quantity")
    if s.endswith("m"):
        return int(float(s[:-1]))
    if s.endswith("n"):
        return int(round(float(s[:-1]) / 1_000_000))
    if s.endswith("u"):
        return int(round(float(s[:-1]) / 1_000))
    if s.endswith("k"):
        return int(round(float(s[:-1]) * 1_000_000))
    return int(round(float(s) * 1000))


def mem_to_bytes(mem: str | int | float) -> int:
    """Parse a memory quantity into integer bytes.

    Mirrors reference unit_convertion.py:15-32 for the binary suffixes
    (``536Mi`` → bytes); additionally accepts decimal SI suffixes and
    exponent notation, which the Kubernetes API may legally emit.
    """
    s = str(mem).strip()
    if not s:
        raise ValueError("empty memory quantity")
    unit2 = s[-2:]
    if unit2 in _BINARY_UNITS:
        return int(float(s[: -len(unit2)]) * _BINARY_UNITS[unit2])
    unit1 = s[-1:]
    if unit1 in _DECIMAL_UNITS and not s[-1].isdigit():
        return int(float(s[:-1]) * _DECIMAL_UNITS[unit1])
    # metrics-server is known to emit milli/micro-byte quantities for memory
    # (e.g. "3988799488m"); round up to whole bytes.
    if unit1 == "m":
        return int(round(float(s[:-1]) / 1_000))
    if unit1 == "u":
        return int(round(float(s[:-1]) / 1_000_000))
    if unit1 == "n":
        return int(round(float(s[:-1]) / 1_000_000_000))
    return int(float(s))


def format_millicores(m: int | float) -> str:
    """``1234 -> "1234m"`` (reference unit_convertion.py:35-36)."""
    return f"{int(m)}m"


def format_bytes_as_mi(b: int | float) -> str:
    """``b -> "<rounded Mi>Mi"`` (reference unit_convertion.py:38-39)."""
    return f"{int(round(b / (1024 * 1024)))}Mi"
