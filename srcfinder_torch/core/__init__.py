"""Host-side utilities of the port: ENVI I/O, geodesy, morphology,
statistics, physics and the stdlib xlsx writer. All numpy; nothing here
touches the device."""
