"""The demo command lines on the port, one module a demo of the JAX
package's ``examples/``, under the same names: ``demo``, ``tvconv_demo``,
``hotswap_demo``, ``stereo_demo``, ``zl_demo``, ``realtime_pipeline``,
``audio_host_demo``, ``csound_demo`` and ``dist_serving_demo``.

Each runs as ``python -m opencl_fft_tpu_torch.examples.<name> [arguments]
[--device cuda|cuda:i|cpu]``, on the card unless ``--device cpu`` is
given, and keeps its JAX counterpart's seeds, signals, sizes, printed lines,
exit codes and wav files. Each splits into a function that builds the
inputs, one that renders and returns arrays (taking ``device``), and the
command line (``main``).
"""
