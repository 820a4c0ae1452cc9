#!/usr/bin/env bash
# Multi-process launcher: the counterpart of the JAX package's
# infra/run_multihost.sh. torchrun starts one process a rank and gives each
# its rank, world size and rendezvous in the environment; the program joins
# the group before any CUDA work (parallel/distributed.init_from_env: NCCL,
# one rank a card, cuda:LOCAL_RANK; gloo on the CPU).
#
# Usage (arguments go to torchrun):
#   cuvs_rag_tpu_torch/infra/run_multihost.sh --standalone --nproc_per_node=4 \
#       -m cuvs_rag_tpu_torch.main --n 10000000 --family ivf_flat
#   cuvs_rag_tpu_torch/infra/run_multihost.sh --standalone --nproc_per_node=2 \
#       -m cuvs_rag_tpu_torch.infra.multihost_worker --device cpu
# Across hosts, pass torchrun's --nnodes, --node_rank and --rdzv_endpoint.
set -euo pipefail

# the CLI joins the process group before its first CUDA allocation
export CUVS_RAG_TPU_MULTIHOST=1

exec torchrun "$@"
