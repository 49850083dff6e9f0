# Container packaging parity with the reference (its Dockerfile installs
# the CLI as a system binary, reference Dockerfile:1-23).  For an NVIDIA
# GPU use a CUDA base image with nvcc and jax[cuda12] (the banded-SW
# kernel compiles with nvcc at first use); this default builds the
# CPU/test image.
FROM python:3.11-slim

RUN apt-get update && apt-get install -y --no-install-recommends g++ \
    && rm -rf /var/lib/apt/lists/*

WORKDIR /opt/monica_tpu
COPY pyproject.toml README.md ./
COPY monica_tpu ./monica_tpu
RUN pip install --no-cache-dir .

# state root lives in a volume; `monica-tpu initialize -r` relocates it
VOLUME ["/data"]
ENV MONICA_TPU_ROOT=/data/monica_root

ENTRYPOINT ["monica-tpu"]
CMD ["--help"]
