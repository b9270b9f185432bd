// The C entry points take their arguments packed by kernels/build.launch:
// one 8-byte slot each, in the order of the entry's parameters, integers
// and pointers as int64 and floats as float64.  One ctypes argument costs
// less to pass than a dozen converted one by one, and a decode step issues
// over a thousand launches.  call_packed unpacks the slots by the
// parameter types of the function it calls, so the order and the types are
// written once, in that function's signature.

#pragma once

#include <string.h>

#include <utility>

namespace launch_args {

template <typename T> struct Slot;
template <> struct Slot<const void*> {
  static const void* get(const long long* a, int i) { return reinterpret_cast<const void*>(a[i]); }
};
template <> struct Slot<void*> {
  static void* get(const long long* a, int i) { return reinterpret_cast<void*>(a[i]); }
};
template <> struct Slot<long long> {
  static long long get(const long long* a, int i) { return a[i]; }
};
template <> struct Slot<int> {
  static int get(const long long* a, int i) { return static_cast<int>(a[i]); }
};
template <> struct Slot<float> {
  static float get(const long long* a, int i) {
    double d;
    memcpy(&d, a + i, sizeof d);
    return static_cast<float>(d);
  }
};

template <typename... A, size_t... I>
int call(int (*f)(A...), const long long* a, std::index_sequence<I...>) {
  return f(Slot<A>::get(a, static_cast<int>(I))...);
}

}  // namespace launch_args

// f(slot 0, slot 1, ...), each slot read as f's parameter of that place
template <typename... A>
int call_packed(int (*f)(A...), const long long* args) {
  return launch_args::call(f, args, std::index_sequence_for<A...>{});
}
