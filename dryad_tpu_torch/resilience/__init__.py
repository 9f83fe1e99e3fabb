"""The fault-drill contract the serving front end honours (``faults``)."""
