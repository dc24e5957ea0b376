"""Static analyses of the port. Only the thread-ownership annotations are
ported so far (``annotations``); ZP-Cert's board certifier and the race
lint that reads the annotations come with a later slice."""
