"""Native IO runtime of the port: the OGIPack reader and writer."""
