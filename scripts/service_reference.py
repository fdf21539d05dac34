"""The JAX reference's numbers for the 304-CU DVFS service stream, for
``chip_smoke.py`` to print beside the port's.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/service_reference.py

Serves ``dvfs_request_stream(32, seed=7)`` (comd / xsbench / lulesh /
minife, ``epoch_us`` 1 or 10, ED2P) through the reference's
``DVFSService`` at ``SimConfig(n_cu=304, n_wf=40, pallas_block_cu=38,
n_epochs=400)``, every other field at its default (the reference's CPU
engine ignores ``pallas_block_cu``), with ``max_batch=8`` and
``coalesce_s=0.001``. Streamed rows do not depend on their batch, so the
numbers do not depend on how the requests coalesce. Prints one JSON
object: the mean over the requests of each report field (pcstall against
static 1.7 GHz).
"""
import json

import numpy as np

from repro.core.simulate import SimConfig
from repro.data.pipeline import dvfs_request_stream
from repro.dvfs_runtime.service import DVFSService

FIELDS = ("ed2p_norm", "energy_norm", "delay_norm", "accuracy")


def main():
    sim = SimConfig(n_cu=304, n_wf=40, pallas_block_cu=38, n_epochs=400)
    with DVFSService(sim, max_batch=8, coalesce_s=0.001) as svc:
        res = svc.map(list(dvfs_request_stream(32, seed=7)))
    print(json.dumps({f: float(np.mean([r["report"][f] for r in res]))
                      for f in FIELDS}))


if __name__ == "__main__":
    main()
