"""One module a kernel: its symbol in the device trace (``SYMBOL``) and
``bound_ms(**shape)``, the least time the card could take for one launch
at those shapes (``perfbench.peaks``)."""
