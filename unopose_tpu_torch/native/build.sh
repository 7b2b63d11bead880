#!/bin/sh
# Build the host library into _build/ (data/native.py runs this at first
# use). The library is written under a temporary name and renamed, so that
# processes building at once never load a half-written file.
set -e
cd "$(dirname "$0")"
mkdir -p _build
CXX=${CXX:-c++}
$CXX -O3 -shared -fPIC -std=c++17 hostops.cpp -o "_build/libhostops.so.$$"
mv -f "_build/libhostops.so.$$" _build/libhostops.so
echo "built $(pwd)/_build/libhostops.so"
