"""The monitor's side of the port. Only the wire messages are here so
far (``mon/messages.py``, which the PG's up_thru request needs); the
monitor daemons come with the OSD daemon."""
