"""OSDMap placement: PG types, object-name hashes, pg_to_up_acting_osds."""
