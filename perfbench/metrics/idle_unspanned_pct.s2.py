"""The share of the device's idle time in the traced window, s2 cells, during
which the host was in no layer span of the program: in its root ``step``'s own
self time or outside its step (harness, entry, loss read)."""
from perfbench.harness.spans import idle_unspanned_pct as read  # noqa: F401
