"""Partitioning rules and activation constraints of the port: the JAX
package's layouts, as tuples of mesh-axis names and DTensor placements."""
