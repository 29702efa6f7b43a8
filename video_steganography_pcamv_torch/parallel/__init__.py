"""Multi-stream and multi-tile serving over an explicit device list
(port of parallel/): `mesh` (streams over devices) and `tile` (one
frame's MB rows over devices, with reference halos)."""
