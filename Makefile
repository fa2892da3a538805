# Native serialization plane build (also auto-built lazily by
# hydrium_tpu/jxl/native.py on first import).

CXX ?= g++
CXXFLAGS ?= -O2 -std=c++17 -fPIC -pthread

all: build/libhydtpu.so

build/libhydtpu.so: cpp/serializer.cc
	mkdir -p build
	$(CXX) $(CXXFLAGS) -shared $< -o $@

# Sanitizer build + standalone differential self-test (SURVEY.md §5:
# race/memory sanitizers for the native plane).
asan: cpp/serializer.cc cpp/selftest.cc
	mkdir -p build
	$(CXX) -O1 -g -std=c++17 -pthread -fsanitize=address,undefined \
	  -fno-sanitize-recover=all cpp/serializer.cc cpp/selftest.cc \
	  -o build/selftest_asan
	./build/selftest_asan

test:
	python -m pytest tests/ -x -q

# On a machine with a GPU: the smoke test of the main path
chip-smoke:
	python chip_smoke.py

clean:
	rm -rf build

.PHONY: all asan test clean chip-smoke
