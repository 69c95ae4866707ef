"""The mgr's side of the port: the report session's wire messages
(``mgr/messages.py``) and the daemons' reporter (``mgr/client.py``).
The mgr daemon and its modules are not ported yet, so nothing is
exported here."""
