"""Spatial SQL function library + SpatialFrame.

Counterpart of ``geomesa_tpu/sql/__init__.py`` (ref: geomesa-spark
geomesa-spark-sql -- SQLTypes, GeometricConstructorFunctions,
GeometricAccessorFunctions, GeometricOutputFunctions,
GeometricProcessingFunctions, SpatialRelationFunctions, GeoMesaRelation
with spatial predicate pushdown, and SpatialRDDProvider). The ``st_*``
functions keep the reference's names and semantics, vectorized over
columnar numpy arrays; ``SpatialFrame`` is the DataFrame-shaped lazy view
whose filters push down into the store's planner (z-range pruning and
the filter scan on the store's device), with ``partitions()`` /
``map_partitions()`` as the RDD analog and ``spatial_join`` as the join
pushdown.

Every ``st_*`` function is re-exported here and listed in ``FUNCTIONS``.
"""

from geomesa_tpu_torch.sql.functions import FUNCTIONS  # noqa: F401
from geomesa_tpu_torch.sql.functions import *  # noqa: F401,F403
from geomesa_tpu_torch.sql.frame import SpatialFrame  # noqa: F401

__all__ = ["SpatialFrame", "FUNCTIONS", *sorted(FUNCTIONS)]
