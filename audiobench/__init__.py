"""The benchmark of opencl_fft_tpu_torch: ``python3 -m audiobench.run`` (see run.py)."""
