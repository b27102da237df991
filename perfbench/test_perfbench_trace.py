"""The trace reader: busy time merged and clipped to the window, kernels
summed by name, idle gaps named by the host span they fall in."""

from perfbench.harness import trace


def test_busy_kernels_and_named_gaps():
    events = [
        ("k9", 50, 100),  # clipped to start at 100
        ("mm", 120, 100),  # overlaps k9: merged
        ("Memcpy HtoD (Pageable -> Device)", 400, 50),  # busy, not a kernel
        ("k9", 900, 200),  # clipped to end at 1000
        ("mm", 1000, 5),  # after the window
    ]
    spans = [("step", 100, 300), ("commit", 500, 700), ("data", 750, 800)]
    t = trace.read(events, (100, 1000), spans)
    assert t.busy_ns == (220 - 100) + 50 + (1000 - 900)
    assert t.kernels == {"k9": (2, 50 + 100), "mm": (1, 100)}
    # gaps: 220-400 (mid 310: after step -> readback), 450-900 (mid 675: commit)
    assert t.gaps_by_phase == {"readback": 180, "commit": 450}
    assert t.top_ops(1) == [["k9", 150e-9]]
    assert abs(t.window_s - 900e-9) < 1e-15
