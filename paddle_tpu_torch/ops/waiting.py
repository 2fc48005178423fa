"""The inventory ops the port has not registered yet, by the JAX
package's op family they wait in.  Every name of
``inventory.OP_INVENTORY`` is in ``registry.OPS`` or here, never both
(``tests/test_torch_op_sweep.py``); all 389 are registered, so it is
empty."""

WAITING = {}
