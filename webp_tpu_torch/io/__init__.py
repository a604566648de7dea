"""Host-side bindings of the decode (the C++ entropy pass)."""
