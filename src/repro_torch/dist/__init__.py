"""Mesh sharding of the port: the placement rules (``sharding``) and the
collectives over the mesh's axes (``comm``)."""
