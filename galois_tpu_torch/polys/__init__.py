"""Polynomial helpers of the port. Only the host-side representation
conversions are ported so far; the ``Poly`` layer is still to come."""
