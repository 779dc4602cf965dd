# surtr_tpu build + test entry points.

CXX ?= g++
CXXFLAGS ?= -O2 -std=c++17 -shared -fPIC -Wall

NATIVE := surtr_tpu/native/libsurtr_native.so

.PHONY: all native test test-all smoke bench clean

all: native

native: $(NATIVE)

$(NATIVE): surtr_tpu/native/objloader.cpp
	$(CXX) $(CXXFLAGS) -o $@ $<

# Tests run on the CPU backend with 8 virtual devices (tests/conftest.py
# forces it, so they never open a GPU).
# `test` = the fast default (pytest.ini gates -m "not slow");
# `test-all` = everything, including the model-scale/pile slow marks.
test:
	JAX_PLATFORMS=cpu python -m pytest tests/ -x -q

test-all:
	JAX_PLATFORMS=cpu python -m pytest tests/ -x -q -m ""

# GPU: the end-to-end smoke test and the benchmark (need an NVIDIA GPU).
smoke:
	python chip_smoke.py

bench:
	python bench.py

clean:
	rm -f $(NATIVE)
