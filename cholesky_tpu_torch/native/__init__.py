"""The port's native host core: `src/mndio.cc` (a copy of the JAX
package's), built by `build.py` at first use and bound by `ext.py`."""
