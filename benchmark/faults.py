"""Faults planted in the port for the window of a run, to read the limits'
upper ends (`python3 -m benchmark.run ... --fault <name>`); a benchmark run
never plants one. Each takes the session's `SLAM` once its set-up is done
and returns what undoes it."""

from __future__ import annotations


def map_unchanged(slam):
    """Mapping leaves the map as it found it: every mapping step runs and
    its result is thrown away, and a keyframe's insertion adds no rows."""
    from monogs_dev_tpu_torch.core import backend

    real_map, real_insert = backend.mapping_iterations, backend.insert_points_evict

    def mapping_iterations(gmap, *args, **kwargs):
        return real_map(gmap, *args, **kwargs)._replace(gmap=gmap)

    def insert_points_evict(gmap, *args, **kwargs):
        return gmap, 0, 0

    backend.mapping_iterations, backend.insert_points_evict = (mapping_iterations,
                                                               insert_points_evict)

    def undo():
        backend.mapping_iterations, backend.insert_points_evict = real_map, real_insert
    return undo
