"""Distribution for the port: logical sharding rules on a torch
``DeviceMesh`` (:mod:`.shardings`), spec trees and placement
(:mod:`.specs`), int8 gradient compression (:mod:`.compression`) and
fault tolerance (:mod:`.fault_tolerance`)."""
