"""Examples of the port (the counterparts of ``accl_tpu/examples``)."""
