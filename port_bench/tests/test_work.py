"""The work counts at both cells' shapes equal values counted by hand."""

from port_bench import harness
from port_bench.work import kernels

PEAKS = {"tf32_flop_per_s": 495e12, "bytes_per_s": 3.35e12}


def test_measure_step_flops_at_the_cell():
    cell = harness.load_cell("measure_h512_train")
    # B=256, T=24, E=10, H=512, z=256, V=130, 2 + 2 layers; 2·m·k·n a product
    enc0 = 2 * (2 * 6144 * 10 * 1536 + 24 * 2 * 256 * 512 * 1536)
    enc1 = 2 * (2 * 6144 * 1024 * 1536 + 24 * 2 * 256 * 512 * 1536)
    heads = 2 * (2 * 256 * 2048 * 1024 + 2 * 256 * 1024 * 256)
    beat = (2 * 256 * 256 * 1024
            + 2 * 1024 * 1 * 1536 + 4 * 2 * 256 * 512 * 1536
            + 2 * 1024 * 512 * 1536 + 4 * 2 * 256 * 512 * 1536)
    inits = 2 * 1024 * 512 * 1024 + 2 * 1024 * 512 * 512 + 2 * 1024 * 512 * 1536
    ticks = 6144 * (2 * 10 * 1536 + 3 * 2 * 512 * 1536 + 2 * 512 * 130)
    forward = enc0 + enc1 + heads + beat + inits + ticks
    assert forward == 118_290_907_136
    assert cell.module("work").step_flops(cell.cfg, cell.traffic) == 3 * forward


def test_dsprites_step_flops_at_the_cell():
    cell = harness.load_cell("dsprites_b128_train")
    # a row: 4 convolutions 64→32→16→8→4, dense 512-256-256-(2×10), the
    # mirror, 4 transposed convolutions 4→8→16→32→64 (the last to 1 channel)
    convs = 2 * 32 * 16 * (1 * 32 * 32 + 32 * 16 * 16 + 32 * 8 * 8 + 32 * 4 * 4)
    dense = 2 * (512 * 256 + 256 * 256 + 2 * 256 * 10 + 10 * 256 + 256 * 256 + 256 * 512)
    deconvs = 2 * 32 * 16 * (32 * 4 * 4 + 32 * 8 * 8 + 32 * 16 * 16 + 1 * 32 * 32)
    row = convs + dense + deconvs
    assert row == 24_919_040
    first_conv = 2 * 32 * 16 * 32 * 32
    assert cell.module("work").step_flops(cell.cfg, cell.traffic) == 128 * (3 * row - first_conv)


def test_recurrence_work_at_the_cell():
    cell = harness.load_cell("measure_h512_train")
    reader = harness.reader("kernel_roofline_pct.recurrence")
    import importlib.util

    path = harness.BENCH / "work" / "recurrence" / "measure_vae.py"
    spec = importlib.util.spec_from_file_location("recurrence_measure_vae", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    calls = mod.calls(cell.cfg, cell.traffic)
    enc = 2 * 24 * 2 * 256 * 512 * 1536          # a biGRU layer's hidden products
    beat = 2 * 4 * 1 * 256 * 512 * 1536          # a beat GRU layer's
    tick = 6144 * (2 * 10 * 1536 + 3 * 2 * 512 * 1536 + 2 * 512 * 130)
    assert sum(w.flop for w in calls) == 3 * (2 * enc + 2 * beat + tick)
    # bytes of the encoder layer's forward: gi, w_hh, b_hh, h0, outs
    gi, w, b, h0, outs = 24 * 2 * 256 * 1536, 2 * 512 * 1536, 2 * 1536, 2 * 256 * 512, \
        24 * 2 * 256 * 512
    assert calls[0] == kernels.Work(enc, 4 * (gi + w + b + h0 + outs))
    # the beat GRU's short chains are bound by their bytes, the rest by operations
    bytes_bound = [w for w in calls if w.bytes / 3.35e12 > w.flop / 495e12]
    assert bytes_bound == [kernels.gru_chain(4, 1, 256, 512, b) for b in (False, True)
                           for _ in range(2)]
    least = mod.least_seconds(cell.cfg, cell.traffic, PEAKS)
    assert least == sum(max(w.flop / 495e12, w.bytes / 3.35e12) for w in calls)
    assert reader is not None
