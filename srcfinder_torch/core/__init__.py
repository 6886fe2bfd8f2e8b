"""Host-side utilities of the port: ENVI I/O, geodesy, morphology,
statistics, physics and the stdlib xlsx writer, all numpy; and the block
prefetcher, which stages host blocks onto the device."""
