# Reproducible container for bart_tpu (reference parity: the reference
# ships a Singularity definition building Ubuntu 20.04 + conda + MPICH;
# see the reference Singularity file and SURVEY.md section 1 packaging row).
#
# CPU image by default; for an NVIDIA GPU install JAX's CUDA build
# instead: `pip install "jax[cuda12]"`.
FROM python:3.12-slim

# g++ builds the native HITRAN line scanner (bart_tpu/native/hitran_scan.cpp)
RUN apt-get update && apt-get install -y --no-install-recommends \
        g++ make && \
    rm -rf /var/lib/apt/lists/*

WORKDIR /opt/bart_tpu
COPY pyproject.toml README.md ./
COPY bart_tpu ./bart_tpu
COPY tests ./tests
COPY examples ./examples

RUN pip install --no-cache-dir -e ".[test,plots]"

# Smoke: full test pyramid on an 8-virtual-device CPU mesh.
# (Run `docker build --build-arg RUN_TESTS=1 .` to gate the image on green.)
ARG RUN_TESTS=0
RUN if [ "$RUN_TESTS" = "1" ]; then python -m pytest tests/ -q; fi

ENTRYPOINT ["bart-tpu"]
