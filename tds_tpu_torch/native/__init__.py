"""Mesh utilities of the port (counterpart of tds_tpu/native): the solid
mesh's mass properties, in numpy."""
