"""vo_bench — the benchmark of ``pmv_tpu_torch`` (see ``vo_bench/run.py``)."""
