"""The single-process gang engine over ranks on one device."""
