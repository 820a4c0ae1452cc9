"""Elastic recovery demo with injected device failure.

The counterpart of the JAX package's `examples/demo_elastic.py`
(demo_index_building_coordinator_mock.py: a simulated multi-GPU build with
a GPU failure injected through the resource-manager seam, SURVEY.md §2
#18 / §4). The failure is injected through DeviceHealthMonitor and the
index heals onto the surviving mesh positions.

    python cuvs_rag_tpu_torch/examples/demo_elastic.py          # 8 positions, the card
    python cuvs_rag_tpu_torch/examples/demo_elastic.py --device cpu
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np

from cuvs_rag_tpu_torch.parallel import elastic
from cuvs_rag_tpu_torch.parallel.mesh import DeviceMesh
from cuvs_rag_tpu_torch.utils.config import FlatParams


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda",
                   help="the device of the mesh's eight positions")
    args = p.parse_args(argv)

    rng = np.random.default_rng(0)
    corpus = rng.standard_normal((4096, 64)).astype(np.float32)
    eix = elastic.ElasticShardedIndex(
        "flat", FlatParams(tile_n=64), corpus,
        dmesh=DeviceMesh([args.device] * 8))
    print(f"built on {eix.dmesh.num_devices} mesh positions")

    probes = corpus[[3, 2048, 4000]]
    _, i = eix.search(None, probes, 1)
    print("self-retrieval:", i[:, 0].tolist())

    print("\ninjecting failure of positions {1, 5} ...")
    eix.monitor = elastic.DeviceHealthMonitor(fail_device_ids={1, 5})
    healed = eix.heal()
    print(f"healed={healed}, now on {eix.dmesh.num_devices} positions")

    _, i = eix.search(None, probes, 1)
    print("self-retrieval after heal:", i[:, 0].tolist())
    assert i[:, 0].tolist() == [3, 2048, 4000]
    print("build history:", eix.history.summary())


if __name__ == "__main__":
    main()
