"""The benchmark's harness: the manifest, weights, traffic, the measured
window, the trace's reduction and the comparison that decides `correct`."""
