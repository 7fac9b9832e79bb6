"""Adapters between Datasets V2 schemas and values and a working copy's SQL
dialect: the GeoPackage's (:mod:`.gpkg`), and the server databases'
(:mod:`.postgis`, :mod:`.mysql`, :mod:`.sqlserver` on :mod:`.base`)."""
