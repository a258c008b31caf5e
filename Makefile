# Build system (the CMakeLists.txt analog): native runtime + tests + bench.

CXX      ?= g++
CXXFLAGS ?= -O2 -shared -fPIC
RT_DIR    = opencl_fft_tpu/runtime
RT_SO     = $(RT_DIR)/libstream_rt.so

.PHONY: all native test bench sweep demo torch-test torch-demo smoke clean

all: native

native: $(RT_SO)

$(RT_SO): $(RT_DIR)/stream_rt.cpp
	$(CXX) $(CXXFLAGS) -o $@ $<

test: native
	python -m pytest tests/ -q

bench: native
	python bench.py

sweep: native
	python -m opencl_fft_tpu.bench.sweep --quick

demo: native
	python examples/demo.py

# the PyTorch/CUDA port: its CPU tests, its demo on the card, its chip smoke
torch-test:
	python -m pytest tests/test_torch_*.py -q

torch-demo:
	python -m opencl_fft_tpu_torch.examples.demo --device cuda

smoke:
	python3 chip_smoke.py

clean:
	rm -f $(RT_SO) bench_details.json demo_reverb.wav sweep*.json \
	      sweep*_table.tex sweep*_plot.csv sweep*_plot.png
