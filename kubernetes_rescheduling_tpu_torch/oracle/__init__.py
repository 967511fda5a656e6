"""Host-side reference twins the tests hold the device code to:
:mod:`oracle.forecast` (the forecaster's numpy twin)."""
