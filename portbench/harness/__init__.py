"""The benchmark harness of distaff_torch: cells, traffic, the measured
window, the trace and the check of what the window produced (run.py is the
entry)."""
