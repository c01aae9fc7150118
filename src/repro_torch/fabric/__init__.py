"""The request arrival process (a copy of ``repro.fabric.tenants``)."""
